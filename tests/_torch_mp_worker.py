"""One rank of tests/test_torch_tensor_parallel.py (scenario ``tensor``,
four ranks) or tests/test_torch_model_parallel.py (scenario ``model``,
two ranks): real OS processes on the CPU (gloo on localhost), started
with the launcher's variables. Imports vlm_clip_tpu_torch only, never
jax.

    python tests/_torch_mp_worker.py SCENARIO INPUTS_PT OUT_DIR

INPUTS_PT holds the configs, the port's param trees (bridged from the
JAX package by the parent) and the inputs; the worker writes
OUT_DIR/rank{r}.pt with what it computed. ``tensor``:

1. CLIP image features on a data 2 x model 2 mesh, pixels sharded over
   data, the features gathered over it;
2. the Qwen text forward at model 2 and model 4 (fp with an untied
   head, int8), and the Qwen vision tower at model 2;
3. the engine on the data 2 x model 2 mesh;
4. PipelineGenerator on a pipe 2 x model 2 mesh (int8 layers, int4 head).

``model``:

1. the engine at tp 2 (fp and NF4), at dp 2, sampled with speculative
   decoding at tp 2 and dp 2, and its indivisible-slots refusal;
2. PipelineGenerator at 2 stages: greedy, an early eos, a repetition
   penalty, sampled (twice, one seed) and its bad-shape refusals;
3. score_video_frames_sharded at seq 2;
4. ``serve_vlm --tp 2`` (rank 0 serves HTTP, rank 1 follows) at a tiny
   stand-in for the 3B config in fp32, two requests, and rank 0's
   tokens of the same requests from a single-process engine.
"""

import io
import json
import os
import sys
import threading


def _engine_runs(data, mesh_of):
    import torch

    from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator
    from vlm_clip_tpu_torch.vlm.qwen_process import VisionInputs
    from vlm_clip_tpu_torch.vlm.sampling import SamplingConfig

    cfg = data["vl_cfg"]
    out = {}
    for case in data["engine"]:
        mesh = mesh_of(case["mesh"])
        gen = QwenVLGenerator(case["params"] if "params" in case
                              else data["vl_params"], cfg, max_len=96,
                              dtype=torch.float32)
        kw = dict(n_slots=case["n_slots"], sync_steps=case["sync"],
                  refill_chunks=case["refill"], mesh=mesh)
        if case.get("sampled"):
            kw.update(sampling=SamplingConfig(**case["sampled"]),
                      spec_k=case["spec_k"])
        if case.get("refuse"):
            try:
                ContinuousBatchingEngine(gen, **kw)
                out[case["name"]] = ""
            except ValueError as e:
                out[case["name"]] = str(e)
            continue
        eng = ContinuousBatchingEngine(gen, **kw)
        ids = case["ids"]
        rids = [eng.submit(ids, VisionInputs(**v), max_new_tokens=m)
                for v, m in zip(case["visions"], case["budgets"])]
        got = eng.flush()
        out[case["name"]] = {
            "tokens": [got[r] for r in rids],
            "cache_rows": int(eng.cache.k.shape[1]),
            "kv_heads": int(eng.cache.k.shape[3])}
    return out


def _tensor(data):
    import torch
    import torch.distributed as dist

    from vlm_clip_tpu_torch.core.dtypes import FP32
    from vlm_clip_tpu_torch.models.clip import get_image_features
    from vlm_clip_tpu_torch.parallel.mesh import (MeshConfig, axis_coordinate,
                                                  axis_group, create_mesh,
                                                  create_pipe_mesh)
    from vlm_clip_tpu_torch.parallel.pipeline import PipelineGenerator
    from vlm_clip_tpu_torch.parallel.sharding import (clip_head_dims,
                                                      clip_param_rules,
                                                      qwen_param_rules,
                                                      shard_params)
    from vlm_clip_tpu_torch.vlm import qwen_model as QM

    out = {}
    d22 = create_mesh(MeshConfig(data=2, model=2), "cpu")
    d14 = create_mesh(MeshConfig(data=1, model=4), "cpu")

    # 1. CLIP image features, data 2 x model 2
    c = data["clip"]
    sp = shard_params(c["params"], d22, clip_param_rules(),
                      head_dim=clip_head_dims(c["cfg"]))
    d, nd = axis_coordinate(d22, "data")
    px = c["pixels"]
    n = px.shape[0] // nd
    with torch.no_grad():
        mine = get_image_features(sp, px[d * n:(d + 1) * n], c["cfg"], FP32)
    feats = mine.new_empty((px.shape[0], mine.shape[1]))
    dist.all_gather_into_tensor(feats, mine.contiguous(),
                                group=axis_group(d22, "data"))
    out["clip"] = feats

    # 2. the Qwen text forward at model 2 and 4, the vision tower at 2
    q = data["text"]
    tcfg = q["cfg"]
    T = q["ids"].shape[1]
    mask = torch.where(torch.tril(torch.ones(T, T, dtype=torch.bool)),
                       0.0, QM._NEG)[None, None]
    pos = torch.arange(T).expand(3, 1, T)
    for name, tree in (("fp", q["fp"]), ("q8", q["q8"])):
        emb = tree["embed_tokens"][q["ids"]]
        for model, mesh in ((2, d22), (4, d14)):
            sp = shard_params(tree, mesh, qwen_param_rules(),
                              head_dim={"": tcfg.head_dim})
            with torch.no_grad():
                logits, _ = QM.text_forward(sp, emb, pos, tcfg, mask)
            out[f"text_{name}_m{model}"] = logits
            out[f"heads_{name}_m{model}"] = QM.local_heads(
                sp["layers"]["attn"], tcfg)[:2]
    v = data["vision"]
    sp = shard_params(v["params"], d22, qwen_param_rules(),
                      head_dim={"": v["cfg"].head_dim})
    with torch.no_grad():
        out["vision"] = QM.vision_forward(sp, *v["args"], v["cfg"])

    # 3. the engine, data 2 x model 2
    out["engine"] = _engine_runs(data, lambda name: create_mesh(
        MeshConfig(data=2, model=2), "cpu"))

    # 4. the pipeline, pipe 2 x model 2
    p = data["pipe"]
    mesh = create_pipe_mesh(2, model=2, device="cpu")
    gen = PipelineGenerator.from_params(p["params"], p["cfg"], mesh,
                                        p["eos"], max_len=64,
                                        dtype=torch.float32,
                                        tp_rules=qwen_param_rules())
    out["pipe_gate"] = type(gen.params["layers"]["mlp"]["gate"]).__name__
    out["pipe"] = gen.generate_text(p["ids"], max_new_tokens=p["max_new"])
    return out


def _model(data, rank):
    import numpy as np
    import torch

    from vlm_clip_tpu_torch.data.video import score_video_frames_sharded
    from vlm_clip_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                  create_pipe_mesh)
    from vlm_clip_tpu_torch.parallel.pipeline import PipelineGenerator
    from vlm_clip_tpu_torch.vlm.sampling import SamplingConfig

    out = {}
    meshes = {"tp2": (1, 2), "dp2": (2, 1)}
    out["engine"] = _engine_runs(data, lambda name: create_mesh(
        MeshConfig(*meshes[name]), "cpu"))

    # 2. the pipeline at 2 stages
    p = data["pipe"]
    mesh = create_pipe_mesh(2, device="cpu")

    def gen(eos):
        return PipelineGenerator.from_params(p["params"], p["cfg"], mesh,
                                             eos, max_len=64,
                                             dtype=torch.float32)

    g = gen(p["eos"])
    out["pipe"] = g.generate_text(p["ids"], max_new_tokens=8)
    out["pipe_penalty"] = g.generate_text(
        p["ids"], max_new_tokens=8,
        sampling=SamplingConfig(repetition_penalty=5.0))
    out["pipe_eos"] = gen(p["eos_stop"]).generate_text(p["ids_eos"],
                                                       max_new_tokens=8)
    scfg = SamplingConfig(do_sample=True, temperature=0.8, top_k=20,
                          top_p=0.9)
    out["pipe_sampled"] = [g.generate_text(p["ids_sampled"],
                                           max_new_tokens=6, sampling=scfg,
                                           seed=5) for _ in range(2)]
    refusals = []
    H = p["cfg"].hidden_size
    for call in (
            lambda: g.generate_text(np.zeros((1, 1, 4), np.int64), 2),
            lambda: g.generate_text(np.zeros((2, 1, 60), np.int64), 8),
            lambda: g.generate_from_embeds(
                torch.zeros(2, 1, 4, H), np.zeros((3, 2, 1, 4), np.int64),
                np.full((2,), 4), 2,
                sampling=SamplingConfig(repetition_penalty=1.2))):
        try:
            call()
            refusals.append("")
        except ValueError as e:
            refusals.append(str(e))
    out["pipe_refusals"] = refusals

    # 3. the sharded video scorer at seq 2
    v = data["video"]
    mesh = create_mesh(MeshConfig(data=1, model=1, seq=2), "cpu")
    out["video"] = score_video_frames_sharded(
        v["params"], v["cfg"], v["frames"], v["emb"], mesh,
        policy=v["policy"])

    # 4. serve_vlm --tp 2
    out["serve"] = _serve(data["serve"], rank)
    return out


def _serve(s, rank):
    import urllib.request

    import numpy as np
    from PIL import Image

    import torch

    from vlm_clip_tpu_torch.cli import serve_vlm as S
    from vlm_clip_tpu_torch.vlm import qwen as QG
    from vlm_clip_tpu_torch.vlm import qwen_model as QM

    QM.qwen25vl_3b = lambda: s["cfg"]  # the tiny stand-in

    class Fp32Generator(QG.QwenVLGenerator):
        """fp32, as the CPU tests of serve_vlm run: in bf16 the ranks'
        partial sums round apart from one process's sum."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **dict(kw, dtype=torch.float32))

    QG.QwenVLGenerator = Fp32Generator
    argv = ["--allow-synth-weights", "--device", "cpu", "--tp", "2",
            "--host", "127.0.0.1", "--port", "0", "--slots", "2",
            "--sync-steps", "2", "--max-len", "320"]
    srv = S.build_server(argv)
    rng = np.random.default_rng(0)
    images = []
    for _ in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(
            buf, format="JPEG")
        images.append(buf.getvalue())
    if rank != 0:
        srv.serve_forever()  # follows until rank 0 stops
        return None
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    got = []
    for body in images:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/generate?max_new=4",
            data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got.append(json.loads(r.read())["tokens"])
    srv.shutdown()
    srv.worker.stop()
    # the same requests through one process's engine
    engine, prep_fn, _, _ = S.build_engine(None, True, max_len=320,
                                           slots=2, sync_steps=2,
                                           device="cpu")
    rids = [engine.submit(*prep_fn(Image.open(io.BytesIO(b)), None),
                          max_new_tokens=4) for b in images]
    fin = engine.flush()
    return {"http": got, "single": [fin[r] for r in rids]}


def main() -> int:
    scenario, inputs, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from vlm_clip_tpu_torch.parallel import distributed as D

    assert D.maybe_initialize(device="cpu") is True
    rank = dist.get_rank()
    data = torch.load(inputs, weights_only=False)
    out = _tensor(data) if scenario == "tensor" else _model(data, rank)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
