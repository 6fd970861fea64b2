"""One rank of tests/test_torch_data_parallel.py: two of these run as
real OS processes on the CPU (gloo on localhost), started with the
launcher's variables (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT). Imports vlm_clip_tpu_torch only, never jax.

    python tests/_torch_dp_worker.py INPUTS_PT OUT_DIR

INPUTS_PT holds the configs, the params and the global batch the parent
made; the worker writes OUT_DIR/rank{r}.pt with what it observed:

1. ``maybe_initialize`` brings the process group up (gloo);
2. two SGD steps of the DP M step (FP32) on this rank's rows, of the
   adapters, of the whole model, and of the adapters clipped to the
   global norm ``clip_norm``; each step's loss and grad norm;
3. ``fused_loss=True`` at world 2 refuses;
4. two Adam steps (eps 1e-2) under ZeRO-1 over the global mesh, the
   moments' shard sizes, and a full-state save by rank 0 after step 1
   restored on every rank, whose step 2 must repeat the in-memory one
   bit for bit; then two such steps clipped to ``clip_norm``;
5. one epoch of the M trainer (ZeRO-1), whose adapter files only rank 0
   may write; then ``load_model`` of the starting adapters, which must
   reach the params and this rank's optimizer shards.
"""

import dataclasses
import os
import sys
import types


def main() -> int:
    inputs, out_dir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from vlm_clip_tpu_torch.bridge import tree_leaves, tree_map
    from vlm_clip_tpu_torch.core import config as PC
    from vlm_clip_tpu_torch.core.dtypes import FP32
    from vlm_clip_tpu_torch.parallel import distributed as D
    from vlm_clip_tpu_torch.parallel.sharding import zero1_place
    from vlm_clip_tpu_torch.train import checkpoint as ckpt
    from vlm_clip_tpu_torch.train.optim import Optimizer
    from vlm_clip_tpu_torch.train.steps import (init_train_state,
                                                make_m_train_step)
    from vlm_clip_tpu_torch.train.trainer_m import CLIPAdapterTrainer

    assert D.maybe_initialize(device="cpu") is True
    assert D.maybe_initialize(device="cpu") is True  # idempotent
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2 and D.is_primary() == (rank == 0)

    data = torch.load(inputs, weights_only=True)
    c = data["cfg"]
    cfg = PC.CLIPConfig(vision=PC.VisionConfig(**c["vision"]),
                        text=PC.TextConfig(**c["text"]),
                        **{k: v for k, v in c.items()
                           if k not in ("vision", "text")})
    acfg = PC.AdapterConfig(**data["acfg"])
    batch = data["batch"]
    n = batch["input_ids"].shape[0] // world
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}

    @dataclasses.dataclass
    class SGD(Optimizer):
        def init(self, params):
            return torch.optim.SGD(params, lr=self.schedule(0))

    @dataclasses.dataclass
    class Adam(Optimizer):
        def init(self, params):
            return torch.optim.Adam(params, lr=self.schedule(0), eps=1e-2)

    def fresh(tx, mesh=None, freeze_clip=True):
        state = init_train_state(
            None, cfg, acfg, tx, device="cpu", freeze_clip=freeze_clip,
            clip_params=tree_map(torch.clone, data["clip"]),
            adapter_params=tree_map(torch.clone, data["adapters"]))
        if mesh is not None:
            state = state._replace(
                opt_state=zero1_place(state.opt_state, mesh, tx))
        return state

    def params(state):
        return tree_map(lambda t: t.detach().clone(), state.adapter_params)

    def record(ms, state, frozen=True):
        return {"loss": [float(m.loss) for m in ms],
                "grad_norm": [float(m.grad_norm) for m in ms],
                "params": params(state) if frozen else
                [params(state), tree_map(lambda t: t.detach().clone(),
                                         state.clip_params)]}

    out = {"rank": rank}
    # 2. the DP step, SGD: adapters only, the whole model, then clipped
    for name, frozen, clip in (("sgd", True, None),
                               ("sgd_full", False, None),
                               ("sgd_clip", True, data["clip_norm"])):
        sgd = SGD(schedule=lambda count: 0.1, weight_decay=0.0,
                  max_grad_norm=clip)
        state = fresh(sgd, freeze_clip=frozen)
        step = make_m_train_step(cfg, acfg, sgd, FP32, freeze_clip=frozen)
        state, m1 = step(state, local)
        state, m2 = step(state, local)
        out[name] = record([m1, m2], state, frozen)

    # 3. the K4 head is single-device
    try:
        make_m_train_step(cfg, acfg, sgd, FP32, fused_loss=True)
        out["fused_refused"] = False
    except ValueError:
        out["fused_refused"] = True

    # 4. ZeRO-1, Adam at eps 1e-2
    mesh = D.global_mesh(device="cpu")
    adam = Adam(schedule=lambda count: 1e-3, weight_decay=0.0,
                max_grad_norm=None)
    step_z = make_m_train_step(cfg, acfg, adam, FP32, zero1_mesh=mesh)
    state = fresh(adam, mesh)
    state, z1 = step_z(state, local)
    path = os.path.join(out_dir, "state.pt")
    ckpt.save_train_state(path, state)
    mem, z2 = step_z(state, local)
    opt = mem.opt_state
    halves = []
    for p, s, shard in zip(opt.params, opt.specs, opt.shards):
        moments = opt.optimizer.state[shard]
        halves.append((p.numel(), moments["exp_avg"].numel(),
                       moments["exp_avg_sq"].numel(), s.is_shard()))
    restored = ckpt.restore_train_state(path, fresh(adam, mesh))
    res, z2r = step_z(restored, local)
    out["zero1"] = dict(
        record([z1, z2], mem), moments=halves,
        restored_step=restored.step,
        resume_bits=float(z2r.loss) == float(z2.loss) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(params(mem)),
                                              tree_leaves(params(res)))))
    adam_clip = Adam(schedule=lambda count: 1e-3, weight_decay=0.0,
                     max_grad_norm=data["clip_norm"])
    step_c = make_m_train_step(cfg, acfg, adam_clip, FP32, zero1_mesh=mesh)
    state = fresh(adam_clip, mesh)
    state, c1 = step_c(state, local)
    state, c2 = step_c(state, local)
    out["zero1_clip"] = record([c1, c2], state)

    # 5. the trainer: ZeRO-1, only rank 0 writes adapter files
    class Loader:
        """One host batch (uint8 images), as data/rafdb.BatchLoader gives."""
        batch_size = batch["input_ids"].shape[0]

        def __len__(self):
            return 1

        def __iter__(self):
            yield types.SimpleNamespace(
                input_ids=batch["input_ids"].numpy(),
                attention_mask=batch["attention_mask"].numpy(),
                images=data["images_u8"].numpy())

    trainer = CLIPAdapterTrainer(
        tree_map(torch.clone, data["clip"]), cfg, acfg, Loader(),
        val_dataloader=Loader(), learning_rate=1e-3, warmup_steps=0,
        output_dir=os.path.join(out_dir, f"trainer{rank}"), policy=FP32,
        zero1_mesh=mesh)
    hist = trainer.train(1)
    out["trainer"] = {"loss": hist[0]["train_loss"],
                      "val": hist[0]["val_loss"],
                      "files": sorted(os.listdir(trainer.output_dir))}
    # load_model reaches the ZeRO-1 shards the next step updates
    start = os.path.join(out_dir, f"start{rank}")
    ckpt.save_adapter_weights(start, data["adapters"])
    trainer.load_model(start)
    opt = trainer.state.opt_state
    want = ckpt.load_adapter_weights(start, acfg, device="cpu")
    out["trainer"]["load_synced"] = all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(trainer.state.adapter_params),
            tree_leaves(want))) and all(
        torch.equal(shard, opt._narrow(p, s))
        for p, s, shard in zip(opt.params, opt.specs, opt.shards)
        if s.is_shard())
    try:
        CLIPAdapterTrainer(tree_map(torch.clone, data["clip"]), cfg, acfg,
                           type("Odd", (Loader,), {"batch_size": 3})(),
                           output_dir=os.path.join(out_dir, "odd"))
        out["odd_refused"] = False
    except ValueError:
        out["odd_refused"] = True
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
