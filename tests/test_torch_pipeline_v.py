"""Pipeline V (the VLM-context-fused adapter) in the port against the JAX
package, on a tiny random CLIP under the FP32 policy on both sides: the
single-prompt class embeddings, the forward (with a context, without,
with a context of the wrong width, with zero contexts), the loss and its
gradients, K6's dropout given the same seed ints, training with the
frozen-feature cache, the 9-tuple evaluation and its report, the V
checkpoint files, and the entry points on the CPU (cli/main_v with the
stub and cache backends, cli/build_context_cache, cli/gen_label, serve's
v-context /classify).

Tolerances: features, probabilities and losses 1e-5 (fp32 on both sides,
summed in another order; the logits carry exp(logit_scale) = 1/0.07, so
they are held at 1e-4); gradients 1e-5 of the largest.
"""

import http.client
import io
import json
import os
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.cli import serve as RS
from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.data import enhanced as RE
from vlm_clip_tpu.data import rafdb as RD
from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
from vlm_clip_tpu.eval import reporting as RREP
from vlm_clip_tpu.models import model_v as RV
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu.ops import fused_adapter as RF
from vlm_clip_tpu.train import checkpoint as RCK
from vlm_clip_tpu.train import trainer_v as RTV
from vlm_clip_tpu.vlm import extractor as RX
from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.cli import serve as S
from vlm_clip_tpu_torch.core.config import EMOTIONS
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data import enhanced as E
from vlm_clip_tpu_torch.data import rafdb as D
from vlm_clip_tpu_torch.data.preprocess import load_and_resize
from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer
from vlm_clip_tpu_torch.eval import reporting as REP
from vlm_clip_tpu_torch.models import model_v as V
from vlm_clip_tpu_torch.ops import fused_adapter as F
from vlm_clip_tpu_torch.train import checkpoint as CK
from vlm_clip_tpu_torch.train import trainer_v as TV
from vlm_clip_tpu_torch.vlm import extractor as X

from _torch_port import jpeg_bytes, port_clip_config, to_torch
from helpers import tiny_clip_config

BOTTLENECK = 16
P = 32  # the tiny config's projection width


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """root/{emotion}/*.jpg, 4 images of 32x32 a class (28)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("rafdb_v")
    rng = np.random.default_rng(0)
    for e in EMOTIONS:
        (root / e).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)
                            ).save(root / e / f"{e}_{i}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def bb():
    """The same tiny backbone for both packages: (ref params, ref cfg,
    ref tokenizer), (port params, port cfg, port tokenizer)."""
    cfg = tiny_clip_config()
    params = init_clip(jax.random.PRNGKey(0), cfg)
    return ((params, cfg, RHash(cfg.text.vocab_size)),
            (to_torch(params), port_clip_config(cfg),
             HashTokenizer(cfg.text.vocab_size)))


def _adapters(seed=0):
    """Reference V adapters with nonzero biases."""
    p = RV.init_v_adapters(jax.random.PRNGKey(seed), P, BOTTLENECK)
    return jax.tree.map(lambda t: t + 0.05 if t.ndim == 1 else t, p)


def _models(bb, seed=0, dropout=0.1):
    """(reference, port) EnhancedCLIPAdapterV with the same adapters,
    FP32 policy, class embeddings encoded."""
    (rp, rcfg, rtok), (pp, pcfg, ptok) = bb
    ref = RV.EnhancedCLIPAdapterV(rp, rcfg, rtok, bottleneck_dim=BOTTLENECK,
                                  dropout=dropout, policy=RFP32)
    ref.adapter_params = _adapters(seed)
    port = V.EnhancedCLIPAdapterV(pp, pcfg, ptok, bottleneck_dim=BOTTLENECK,
                                  dropout=dropout, policy=FP32)
    port.adapter_params = to_torch(ref.adapter_params)
    ref.encode_emotion_descriptions()
    port.encode_emotion_descriptions()
    return ref, port


def _close(got, want, atol=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


def _feats(seed, n=6, d=P, zero=False):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return np.zeros_like(f) if zero else f


def test_single_prompt_embeddings_match_reference(bb):
    (rp, rcfg, rtok), (pp, pcfg, ptok) = bb
    want = RV.encode_single_prompt_embeddings(rp, rcfg, rtok, RFP32)
    got = V.encode_single_prompt_embeddings(pp, pcfg, ptok, FP32)
    assert tuple(got.shape) == (7, P) and got.dtype == torch.float32
    _close(got, want)
    _close(got.norm(dim=-1), np.ones(7))


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("ctx", ["context", "none", "mismatch", "zeros"])
def test_v_forward_matches_reference(bb, ctx, impl, capsys):
    """v_forward's logits: a context (the average fusion), none, one of
    the wrong width (dropped with the reference's warning) and zero
    contexts (still through the context adapter); the dynamic text
    branch and the cached one."""
    ref, port = _models(bb, seed=1)
    img = _feats(2)
    c = {"context": _feats(3), "none": None,
         "mismatch": _feats(3, d=P + 8), "zeros": _feats(3, zero=True)}[ctx]
    for cached in (False, True):
        want = RV.v_forward(
            ref.adapter_params, jnp.asarray(img),
            ref.emotion_embedding_tensor, ref.clip_params["logit_scale"],
            None if c is None else jnp.asarray(c),
            cached_text_emb=ref.adapted_emotion_embedding_tensor
            if cached else None)
        want_out = capsys.readouterr().out
        got = V.v_forward(
            port.adapter_params, torch.from_numpy(img),
            port.emotion_embedding_tensor,
            port.clip_params["logit_scale"],
            None if c is None else torch.from_numpy(c),
            cached_text_emb=port.adapted_emotion_embedding_tensor
            if cached else None, impl=impl)
        assert capsys.readouterr().out == want_out
        assert ("mismatch" in want_out) == (ctx == "mismatch")
        assert tuple(got.shape) == (6, 7)
        _close(got, want, 1e-4)
    if ctx == "zeros":  # zeros are not "no context": the adapter's bias
        no_ctx = V.v_forward(port.adapter_params, torch.from_numpy(img),
                             port.emotion_embedding_tensor,
                             port.clip_params["logit_scale"], None)
        assert not torch.allclose(got, no_ctx, atol=1e-3)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_v_loss_and_grads_match_reference(bb, impl):
    ref, port = _models(bb, seed=4)
    img, c = _feats(5), _feats(6)
    labels = np.random.default_rng(7).integers(0, 7, (6,))
    args = (jnp.asarray(labels), ref.emotion_embedding_tensor,
            ref.clip_params["logit_scale"], None, 0.2, 0.2, 0.3, 0.1)
    want, want_g = jax.value_and_grad(RV.v_loss_fn)(
        ref.adapter_params, jnp.asarray(img), jnp.asarray(c), *args)
    params = port.adapter_params
    for t in tree_leaves(params):
        t.requires_grad_(True)
        t.grad = None
    loss = V.v_loss_fn(params, torch.from_numpy(img), torch.from_numpy(c),
                       torch.from_numpy(labels),
                       port.emotion_embedding_tensor,
                       port.clip_params["logit_scale"], None, 0.2, 0.2, 0.3,
                       0.1, impl)
    _close(loss, want)
    loss.backward()
    top = max(float(np.abs(np.asarray(g)).max())
              for g in jax.tree.leaves(want_g))
    for name in ("visual", "text", "context"):
        for layer in ("fc1", "fc2"):
            for key in ("kernel", "bias"):
                _close(params[name][layer][key].grad,
                       want_g[name][layer][key], 1e-5 * top)


def test_v_forward_dropout_is_k6_with_the_same_seeds(bb):
    """With dropout, each adapter call takes K6 with a seed drawn from the
    generator (visual, context, text, in that order); the reference's
    Pallas K6 given the same seed ints applies the same masks, so the
    logits agree."""
    ref, port = _models(bb, seed=8)
    img, c = _feats(9, n=300), _feats(10, n=300)  # 300: two hash tiles
    gen = torch.Generator().manual_seed(11)
    seeds = [int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g))
             for g in [torch.Generator().manual_seed(11)] for _ in range(3)]
    got = V.v_forward(port.adapter_params, torch.from_numpy(img),
                      port.emotion_embedding_tensor,
                      port.clip_params["logit_scale"], torch.from_numpy(c),
                      dropout=0.1, deterministic=False, generator=gen)

    def k6(name, x, r, seed):
        p = ref.adapter_params[name]
        return RF.feature_adapter_blend_fused(
            jnp.asarray(x), p["fc1"]["kernel"], p["fc1"]["bias"],
            p["fc2"]["kernel"], p["fc2"]["bias"], r, 0.1,
            jnp.int32(seed))

    vis = k6("visual", img, 0.2, seeds[0])
    ctx = k6("context", c, 0.3, seeds[1])
    comb = (vis + ctx) / 2.0
    comb = comb / jnp.linalg.norm(comb, axis=-1, keepdims=True)
    txt = k6("text", ref.emotion_embedding_tensor, 0.2, seeds[2])
    want = jnp.exp(ref.clip_params["logit_scale"]) * comb @ txt.T
    _close(got, want, 1e-4)
    plain = V.v_forward(port.adapter_params, torch.from_numpy(img),
                        port.emotion_embedding_tensor,
                        port.clip_params["logit_scale"], torch.from_numpy(c))
    assert not torch.allclose(got, plain, atol=1e-3)  # dropout did act


def _ds(root, pkg, extractor, train=True):
    cls = pkg.EnhancedFolderDataset if train \
        else pkg.EnhancedFolderDatasetWithContext
    return cls(root, extractor, mode="train" if train else "test",
               image_size=32, feature_dim=P, seed=3)


def _stubs(bb):
    (rp, rcfg, rtok), (pp, pcfg, ptok) = bb
    return (RX.StubContextExtractor(rp, rcfg, rtok, RFP32),
            X.StubContextExtractor(pp, pcfg, ptok, FP32))


def test_enhanced_datasets_match_reference(bb, root, tmp_path):
    """The scan, the per-class cap, the contexts resolved at
    construction, the zero-vector fallback and the dummy for an image that
    does not decode."""
    import shutil

    tree = tmp_path / "tree"
    shutil.copytree(root, tree)
    (tree / "sad" / "broken.jpg").write_bytes(b"not a jpeg")
    rx, px = _stubs(bb)
    for train in (True, False):
        want = _ds(str(tree), RE, rx, train)
        got = _ds(str(tree), E, px, train)
        assert len(got) == len(want) == 29
        assert got.image_paths == want.image_paths
        for i in range(len(got)):
            g, w = got[i], want[i]
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:3] == w[1:3]
            _close(g[3], w[3])
            if not train:
                assert g[4] == w[4]
        bad = got.image_paths.index(str(tree / "sad" / "broken.jpg"))
        assert got[bad][1] == 0 and not got[bad][3].any()
    capped = E.EnhancedFolderDataset(str(tree), None, max_images=14,
                                     image_size=32, feature_dim=P, seed=3)
    assert len(capped) == 14 and not capped[0][3].any()  # 2 a class


def _loader(ds, pkg, train=True):
    if train:
        return pkg.BatchLoader(ds, 8, shuffle=True, drop_last=True, seed=0)
    return pkg.BatchLoader(ds, 10)


def test_train_matches_reference(bb, root):
    """Two epochs at dropout 0 (a fresh shuffle each, image features
    cached after the first, contexts from the stub) give the reference's
    per-epoch losses, adapters and adapted class embeddings, and its
    printed lines."""
    ref, port = _models(bb, seed=12, dropout=0.0)
    rx, px = _stubs(bb)
    want = RTV.train_model(ref, _loader(_ds(root, RE, rx), RD),
                           num_epochs=2, learning_rate=3e-3)
    got = TV.train_model(port, _loader(_ds(root, E, px), D), num_epochs=2,
                         learning_rate=3e-3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("visual", "text", "context"):
        for layer in ("fc1", "fc2"):
            for key in ("kernel", "bias"):
                _close(port.adapter_params[name][layer][key],
                       ref.adapter_params[name][layer][key])
    _close(port.adapted_emotion_embedding_tensor,
           ref.adapted_emotion_embedding_tensor)


def test_train_with_dropout_runs_k6_masks(bb, root, capsys):
    """Dropout 0.1 in training: finite decreasing-or-not losses, the
    reference's printed lines, and a different result from dropout 0
    (the masks act)."""
    _, port = _models(bb, seed=13)
    _, px = _stubs(bb)
    losses = TV.train_model(port, _loader(_ds(root, E, px), D),
                            num_epochs=2, learning_rate=3e-3, seed=5)
    out = capsys.readouterr().out
    assert "Epoch 1/2 - Average Training Loss: " in out
    assert "Epoch 2/2 - Average Training Loss: " in out
    assert out.rstrip().endswith("Training complete.")
    _, port0 = _models(bb, seed=13, dropout=0.0)
    losses0 = TV.train_model(port0, _loader(_ds(root, E, px), D),
                             num_epochs=2, learning_rate=3e-3, seed=5)
    assert np.isfinite(losses).all() and losses != losses0


def test_evaluate_enhanced_model_matches_reference(bb, root, capsys):
    """The 9-tuple, the text report and the context analytics."""
    ref, port = _models(bb, seed=14)
    rx, px = _stubs(bb)
    want = RREP.evaluate_enhanced_model(
        ref, _loader(_ds(root, RE, rx, False), RD, False))
    got = REP.evaluate_enhanced_model(
        port, _loader(_ds(root, E, px, False), D, False))
    assert len(got.astuple()) == len(want.astuple()) == 9
    assert got.accuracy == pytest.approx(want.accuracy)
    np.testing.assert_array_equal(got.conf_matrix, want.conf_matrix)
    assert got.class_report == want.class_report
    np.testing.assert_array_equal(got.predictions, want.predictions)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.image_paths == want.image_paths
    assert got.contexts == want.contexts
    _close(got.confidences, want.confidences, 1e-5)
    _close(got.similarity_scores, want.similarity_scores, 1e-5)
    capsys.readouterr()
    REP.display_results_with_contexts(got, plots=False)
    mine = capsys.readouterr().out
    import matplotlib
    matplotlib.use("Agg")
    cwd = os.getcwd()
    os.chdir(os.path.dirname(root))
    try:
        RREP.display_results_with_contexts(want)
    finally:
        os.chdir(cwd)
    theirs = capsys.readouterr().out
    assert mine == theirs.replace(
        "\nConfusion matrix plot saved as confusion_matrix.png\n", "")
    assert REP.analyze_context_quality(got.contexts, got.labels) == \
        RREP.analyze_context_quality(want.contexts, want.labels)
    assert capsys.readouterr().out.count("CONTEXT DESCRIPTION ANALYSIS") == 2


def test_v_checkpoints_round_trip(tmp_path):
    """The V file: the port's save loads in both packages, the
    reference's in the port, each leaf exact."""
    p = _adapters(15)
    tp = to_torch(p)
    CK.save_v_adapters(str(tmp_path / "port.pt"), tp)
    RCK.save_v_adapters(str(tmp_path / "ref.pt"), p)
    back = RCK.load_v_adapters(str(tmp_path / "port.pt"))
    mine = CK.load_v_adapters(str(tmp_path / "ref.pt"), device="cpu")
    again = CK.load_v_adapters(str(tmp_path / "port.pt"), device="cpu")
    for name in ("visual", "text", "context"):
        for layer in ("fc1", "fc2"):
            for key in ("kernel", "bias"):
                want = np.asarray(p[name][layer][key])
                np.testing.assert_array_equal(
                    np.asarray(back[name][layer][key]), want)
                np.testing.assert_array_equal(
                    mine[name][layer][key].numpy(), want)
                np.testing.assert_array_equal(
                    again[name][layer][key].numpy(), want)


def _tiny_cli(monkeypatch, bb):
    """Point both packages' CLI plumbing at the tiny backbone, under FP32
    with fixed adapters (so the two runs start from one state) and
    dropout 0 (the two packages draw different masks)."""
    from vlm_clip_tpu.cli import common as rcommon
    from vlm_clip_tpu_torch.cli import common

    (rp, rcfg, rtok), (pp, pcfg, ptok) = bb
    monkeypatch.setattr(common, "load_backbone",
                        lambda *a, **k: (pp, pcfg))
    monkeypatch.setattr(common, "make_tokenizer", lambda *a, **k: ptok)
    monkeypatch.setattr(rcommon, "load_backbone",
                        lambda *a, **k: (rp, rcfg))
    monkeypatch.setattr(rcommon, "make_tokenizer", lambda *a, **k: rtok)
    for mod, pol, conv in ((RV, RFP32, lambda t: t),
                           (V, FP32, to_torch)):
        init = mod.EnhancedCLIPAdapterV.__init__

        def patched(self, *a, _init=init, _pol=pol, _conv=conv, **k):
            _init(self, *a, **{**k, "policy": _pol, "dropout": 0.0})
            self.adapter_params = _conv(_adapters(16))

        monkeypatch.setattr(mod.EnhancedCLIPAdapterV, "__init__", patched)
    for mod, pol in ((RX, RFP32), (X, FP32)):
        init = mod.StubContextExtractor.__init__

        def patched(self, *a, _init=init, _pol=pol, **k):
            _init(self, *a[:3], policy=_pol)

        monkeypatch.setattr(mod.StubContextExtractor, "__init__", patched)


def _main_v_args(root, tmp_path, backend, tag):
    args = ["--train-dir", root, "--test-dir", root, "--batch-size", "8",
            "--num-epochs", "2", "--bottleneck-dim", str(BOTTLENECK),
            "--learning-rate", "3e-3", "--vlm-backend", backend,
            "--adapter-out", str(tmp_path / f"{tag}.pt")]
    if backend == "cache":
        args += ["--context-cache-dir", str(tmp_path / "cache")]
    return args


def _build_cache(root, out, image_size=32):
    from vlm_clip_tpu_torch.cli import build_context_cache

    return build_context_cache.main(
        ["--data-dir", root, "--out-dir", str(out), "--image-size",
         str(image_size), "--batch-size", "3", "--device", "cpu"])


@pytest.mark.parametrize("backend", ["stub", "cache"])
def test_cli_main_v_on_cpu_matches_reference(bb, root, monkeypatch,
                                             tmp_path, capsys, backend):
    """cli/main_v end to end on the CPU: the per-epoch losses, the saved
    adapters and the 9-tuple equal the reference CLI's from the same
    state (contexts from the stub, or from a cache the port built)."""
    from vlm_clip_tpu.cli import main_v as rmain
    from vlm_clip_tpu_torch.cli import main_v

    _tiny_cli(monkeypatch, bb)
    monkeypatch.setenv("VLM_CLIP_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.chdir(tmp_path)
    if backend == "cache":
        _build_cache(root, tmp_path / "cache")
    F.reset_launch_counts()
    got = main_v.main(_main_v_args(root, tmp_path, backend, "port")
                      + ["--device", "cpu", "--no-plots"])
    out = capsys.readouterr().out
    assert "ENHANCED CLIP-ADAPTER EVALUATION RESULTS" in out
    assert not any(F.launch_counts().values())  # CPU: plain versions
    import matplotlib
    matplotlib.use("Agg")
    rmain.main(_main_v_args(root, tmp_path, backend, "ref"))
    want_out = capsys.readouterr().out
    want_losses = [float(ln.rsplit(" ", 1)[1]) for ln in want_out.splitlines()
                   if "Average Training Loss" in ln]
    np.testing.assert_allclose(got["losses"], want_losses, atol=1e-4)
    mine = CK.load_v_adapters(str(tmp_path / "port.pt"), device="cpu")
    theirs = CK.load_v_adapters(str(tmp_path / "ref.pt"), device="cpu")
    for a, b in zip(tree_leaves(mine), tree_leaves(theirs)):
        _close(a, b.numpy())
    res = got["results"]
    assert len(res.astuple()) == 9 and len(res.labels) == 28
    assert res.contexts and all(c != E.NO_DESCRIPTION for c in res.contexts)
    assert got["context_stats"]["success_rate"] == 100.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main_v.main(["--train-dir", root, "--test-dir", root])


def test_cli_build_context_cache_matches_reference(bb, root, monkeypatch,
                                                   tmp_path):
    """Both key sets (path hash, content hash), the same descriptions and
    features as the reference's builder, batched with a ragged tail."""
    from vlm_clip_tpu.cli import build_context_cache as rbuild

    _tiny_cli(monkeypatch, bb)
    got = _build_cache(root, tmp_path / "port")
    rbuild.main(["--data-dir", root, "--out-dir", str(tmp_path / "ref"),
                 "--image-size", "32", "--batch-size", "3"])
    assert got == {"images": 28, "keys": 56, "failures": 0}
    texts = [json.loads((tmp_path / d / "contexts.json").read_text())
             for d in ("port", "ref")]
    assert texts[0] == texts[1] and len(texts[0]) == 56
    feats = [np.load(tmp_path / d / "features.npz") for d in ("port", "ref")]
    assert sorted(feats[0].files) == sorted(feats[1].files) == sorted(
        texts[0])
    for k in feats[0].files:
        _close(feats[0][k], feats[1][k])
    path = sorted(D.scan_class_folders(Path(root)))[0][0]

    keys = {X.CachedContextExtractor.key_for(path),
            X.CachedContextExtractor.key_for(load_and_resize(path, 32))}
    assert keys <= set(texts[0])


def test_cli_gen_label_matches_reference_and_isolates_failures(
        bb, root, monkeypatch, tmp_path):
    """The jsonl records equal the reference's; where a chunk's batched
    extraction raises (one image that makes the VLM fail), the port
    retries the chunk one image at a time and only that image's caption
    is null, where the reference nulls the whole chunk."""
    from vlm_clip_tpu.cli import gen_label as rgen
    from vlm_clip_tpu_torch.cli import gen_label

    _tiny_cli(monkeypatch, bb)
    argv = ["--data-dir", root, "--image-size", "32", "--chunk", "8"]
    got = gen_label.main(argv + ["--out", str(tmp_path / "port.jsonl"),
                                 "--device", "cpu", "--no-native"])
    rgen.main(argv + ["--out", str(tmp_path / "ref.jsonl"), "--no-native"])
    rows = [[json.loads(ln) for ln in (tmp_path / f).read_text().split("\n")
             if ln] for f in ("port.jsonl", "ref.jsonl")]
    assert rows[0] == rows[1] and got == {"records": 28, "captions": 28}

    bad = sorted(D.scan_class_folders(Path(root)))[10][0]
    bad_img = load_and_resize(bad, 32)
    for mod in (X, RX):
        stub = mod.StubContextExtractor
        one = stub.extract_context_from_image

        def failing(self, image, _one=one):
            if np.array_equal(np.asarray(image), bad_img):
                raise RuntimeError("the VLM failed on this image")
            return _one(self, image)

        monkeypatch.setattr(stub, "extract_context_from_image", failing)
        monkeypatch.setattr(stub, "extract_contexts_batch", lambda self, ims:
                            [self.extract_context_from_image(i) for i in ims])
    got = gen_label.main(argv + ["--out", str(tmp_path / "port2.jsonl"),
                                 "--device", "cpu", "--no-native"])
    rgen.main(argv + ["--out", str(tmp_path / "ref2.jsonl"), "--no-native"])
    port2, ref2 = ([json.loads(ln) for ln in
                    (tmp_path / f).read_text().split("\n") if ln]
                   for f in ("port2.jsonl", "ref2.jsonl"))
    nulls = [r["path"] for r in port2 if r["caption"] is None]
    assert nulls == [bad] and got["captions"] == 27
    assert [r for r in port2 if r["path"] != bad] == \
        [r for r in rows[0] if r["path"] != bad]
    assert sum(r["caption"] is None for r in ref2) == 8  # its whole chunk


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read().decode()))
    conn.close()
    return out


def test_serve_v_classify_matches_reference(bb, tmp_path):
    """v-context mode: the strict V load, the context cache by content
    hash (a cached image, and one the cache lacks: zeros), then /classify
    over HTTP equals the reference's build_predict_fn; a T file is
    refused."""
    from PIL import Image

    ref_bb, port_bb = bb
    ckpt = str(tmp_path / "v.pt")
    RCK.save_v_adapters(ckpt, _adapters(17))
    body = jpeg_bytes(18)
    seen = load_and_resize(Image.open(io.BytesIO(body)), 32)
    cache = tmp_path / "cache"
    cache.mkdir()
    key = X.CachedContextExtractor.key_for(seen)
    (cache / "contexts.json").write_text(json.dumps({key: "a sad face"}))
    np.savez(cache / "features.npz", **{key: _feats(19, n=1)[0]})
    ref_fn, ref_mode, _ = RS.build_predict_fn(
        "tiny", v_adapter_ckpt=ckpt, context_cache=str(cache),
        backbone=ref_bb, policy=RFP32, max_batch=4)
    F.reset_launch_counts()
    fn, mode, cfg = S.build_predict_fn(
        "tiny", v_adapter_ckpt=ckpt, context_cache=str(cache),
        backbone=port_bb, policy=FP32, max_batch=4)
    assert mode == ref_mode == "v-context+cache"
    u8 = np.random.default_rng(0).integers(0, 255, (4, 32, 32, 3), np.uint8)
    u8[1] = seen
    np.testing.assert_allclose(fn(u8), np.asarray(ref_fn(u8)), atol=1e-5)
    classifier = S.BatchingClassifier(fn, cfg.vision.image_size,
                                      max_batch=4, window_ms=5.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), S.make_handler(
        classifier, "tiny"))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        outs = [_request(srv.server_address[1], "POST", "/classify", b)
                for b in (body, jpeg_bytes(20))]
    finally:
        srv.shutdown()
        srv.server_close()
    for b, (status, out) in zip((body, jpeg_bytes(20)), outs):
        u8 = np.zeros((4, 32, 32, 3), np.uint8)
        u8[0] = load_and_resize(Image.open(io.BytesIO(b)), 32)
        assert status == 200
        probs = [out["probs"][e] for e in EMOTIONS]
        np.testing.assert_allclose(probs, np.asarray(ref_fn(u8))[0],
                                   atol=1e-5)
    assert not any(F.launch_counts().values())  # CPU: plain versions
    RCK.save_t_adapters(str(tmp_path / "t.pt"), {
        k: v for k, v in _adapters(17).items() if k != "context"})
    with pytest.raises(ValueError, match="not a V checkpoint"):
        S.build_predict_fn("tiny", v_adapter_ckpt=str(tmp_path / "t.pt"),
                           backbone=port_bb, policy=FP32)
