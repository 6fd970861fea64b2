"""Pipeline T (the CLIP-Adapter experiment) in the port against the JAX
package, on a tiny random CLIP under the FP32 policy on both sides: the
prompt bank, the adapter logits, loss and gradients, both predict modes,
training with the frozen-feature cache, the evaluation and the 2x2
comparison, the T checkpoint files, and the three entry points
(cli/compare_t, cli/predict_image, serve's t-adapter /classify) on the
CPU.

Tolerances: features, probabilities and losses 1e-5 (fp32 on both sides,
summed in another order; a probability is a softmax of 100x cosine, so
the class-level checks use 1e-4); gradients 1e-5 of the largest.
"""

import http.client
import io
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.cli import serve as RS
from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.data import preprocess as RP
from vlm_clip_tpu.data import rafdb as RD
from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
from vlm_clip_tpu.eval import compare as RCMP
from vlm_clip_tpu.eval import evaluate as REV
from vlm_clip_tpu.models import model_t as RT
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu.train import checkpoint as RCK
from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.cli import serve as S
from vlm_clip_tpu_torch.core.config import EMOTIONS
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data import rafdb as D
from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer
from vlm_clip_tpu_torch.eval import compare as CMP
from vlm_clip_tpu_torch.eval import evaluate as EV
from vlm_clip_tpu_torch.models import model_t as T
from vlm_clip_tpu_torch.ops import fused_adapter as F
from vlm_clip_tpu_torch.train import checkpoint as CK
from vlm_clip_tpu_torch.train import trainer_t as TT

from _torch_port import jpeg_bytes, port_clip_config, to_torch
from helpers import tiny_clip_config

BOTTLENECK = 16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """root/{emotion}/*.jpg, 4 images of 32x32 a class (28)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("rafdb_flat")
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


@pytest.fixture(scope="module")
def ref_models(bb):
    """One reference CLIPAdapterT and zero-shot model for the module (each
    instance jits its own predict functions); tests set the adapters."""
    rp, rcfg, rtok = bb[0]
    return (RT.CLIPAdapterT(rp, rcfg, rtok, bottleneck_dim=BOTTLENECK,
                            policy=RFP32),
            RT.ZeroShotEmotionRecognition(rp, rcfg, rtok, policy=RFP32))


def _adapters(seed=0):
    """Reference T adapters with nonzero biases."""
    p = RT.init_t_adapters(jax.random.PRNGKey(seed), 32, BOTTLENECK)
    return jax.tree.map(lambda t: t + 0.05 if t.ndim == 1 else t, p)


def _models(bb, ref_models, seed=0):
    """(reference CLIPAdapterT, port CLIPAdapterT) with the same
    adapters."""
    pp, pcfg, ptok = bb[1]
    ref = ref_models[0]
    ref.adapter_params = _adapters(seed)
    ref.adapted_class_emb = None
    port = T.CLIPAdapterT(pp, pcfg, ptok, bottleneck_dim=BOTTLENECK,
                          policy=FP32)
    port.adapter_params = to_torch(ref.adapter_params)
    return ref, port


def _close(got, want, atol=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


def test_emotion_bank_matches_reference(bb, ref_models):
    ref, port = _models(bb, ref_models)
    assert tuple(port.bank.per_description.shape) == (7, 5, 32)
    _close(port.bank.per_description, ref.bank.per_description)
    _close(port.bank.mean, ref.bank.mean)
    assert port.temperature == pytest.approx(ref.temperature, rel=1e-7)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_logits_loss_and_grads_match_reference(bb, ref_models, impl):
    """t_logits, t_loss_fn and its gradients to every adapter leaf; "auto"
    goes through K6 (its plain version with autograd on the CPU),
    "torch" through the plain composition."""
    ref, port = _models(bb, ref_models, seed=1)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(8, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    labels = rng.integers(0, 7, (8,))
    args = (ref.bank.mean, 0.2, 0.3, jnp.float32(ref.temperature))
    want_logits = RT.t_logits(ref.adapter_params, jnp.asarray(feats), *args)
    want_loss, want_g = jax.value_and_grad(RT.t_loss_fn)(
        ref.adapter_params, jnp.asarray(feats), jnp.asarray(labels), *args)
    params = port.adapter_params
    for t in tree_leaves(params):
        t.requires_grad_(True)
        t.grad = None
    pargs = (port.bank.mean, 0.2, 0.3, port.temperature)
    _close(T.t_logits(params, torch.from_numpy(feats), *pargs, impl=impl),
           want_logits, 1e-4)
    loss = T.t_loss_fn(params, torch.from_numpy(feats),
                       torch.from_numpy(labels), *pargs, impl=impl)
    _close(loss, want_loss)
    loss.backward()
    top = max(float(np.abs(np.asarray(g)).max())
              for g in jax.tree.leaves(want_g))
    for name in ("visual", "text"):
        for layer in ("fc1", "fc2"):
            for key in ("kernel", "bias"):
                _close(params[name][layer][key].grad,
                       want_g[name][layer][key], 1e-5 * top)


@pytest.mark.parametrize("adapted", [True, False])
def test_predict_modes_match_reference(bb, ref_models, adapted):
    """predict and predict_with_all_descriptions, the adapter model (with
    its class embeddings refreshed) and the zero-shot baseline."""
    pp, pcfg, ptok = bb[1]
    if adapted:
        ref, port = _models(bb, ref_models, seed=2)
        ref.update_emotion_embeddings()
        port.update_emotion_embeddings()
        _close(port.adapted_class_emb, ref.adapted_class_emb)
    else:
        ref = ref_models[1]
        port = T.ZeroShotEmotionRecognition(pp, pcfg, ptok, policy=FP32)
    px = np.random.default_rng(1).normal(size=(3, 3, 32, 32)).astype(
        np.float32)
    for fn in ("predict", "predict_with_all_descriptions"):
        got = getattr(port, fn)(torch.from_numpy(px))
        _close(got, getattr(ref, fn)(jnp.asarray(px)), 1e-4)
        _close(got.sum(-1), np.ones(3), 1e-5)


def _loaders(root, pkg, seed=0, batch=8):
    ds = pkg.FolderDataset(root, image_size=32)
    return pkg.BatchLoader(ds, batch, shuffle=True, drop_last=True,
                           seed=seed)


def test_train_matches_reference(bb, ref_models, root):
    """Two epochs (a fresh shuffle each, features cached after the first)
    give the reference's per-epoch losses and adapters."""
    ref, port = _models(bb, ref_models, seed=3)
    want = ref.train(_loaders(root, RD), num_epochs=2, learning_rate=3e-3)
    got = port.train(_loaders(root, D), num_epochs=2, learning_rate=3e-3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("visual", "text"):
        for layer in ("fc1", "fc2"):
            for key in ("kernel", "bias"):
                _close(port.adapter_params[name][layer][key],
                       ref.adapter_params[name][layer][key])
    _close(port.adapted_class_emb, ref.adapted_class_emb)


def test_feature_cache_equivalence(bb, ref_models, root):
    """Training from cached features equals recomputing the frozen tower
    every epoch; the cache is one [N, P] tensor written in place."""
    def run(cache):
        _, port = _models(bb, ref_models, seed=4)
        return port.train(_loaders(root, D, seed=5, batch=14), num_epochs=3,
                          learning_rate=1e-3, cache_image_features=cache)

    np.testing.assert_allclose(run(True), run(False), atol=1e-5)
    cache = TT.FeatureCache(5, 3, device="cpu")
    store = cache.feats
    calls = []

    def compute():
        calls.append(1)
        return torch.arange(6.0).reshape(2, 3)

    cache.lookup_or_compute(np.array([4, 1]), compute)
    got = cache.lookup_or_compute(np.array([1, 4]), compute)
    assert len(calls) == 1 and cache.feats is store
    torch.testing.assert_close(got, torch.tensor([[3.0, 4, 5], [0, 1, 2]]))


def _eval_loader(root, pkg):
    return pkg.BatchLoader(pkg.FolderDataset(root, image_size=32), 10,
                           pad_final=True)


@pytest.mark.parametrize("all_desc", [False, True])
def test_evaluate_model_matches_reference(bb, ref_models, root, all_desc):
    ref, port = _models(bb, ref_models, seed=6)
    ref.update_emotion_embeddings()
    port.update_emotion_embeddings()
    want = REV.evaluate_model(ref, _eval_loader(root, RD), all_desc)
    got = EV.evaluate_model(port, _eval_loader(root, D), all_desc)
    assert len(got.astuple()) == len(want.astuple()) == 8
    assert got.accuracy == pytest.approx(want.accuracy)
    np.testing.assert_array_equal(got.conf_matrix, want.conf_matrix)
    assert got.class_report == want.class_report
    np.testing.assert_array_equal(got.predictions, want.predictions)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.image_paths == want.image_paths
    _close(got.confidences, want.confidences, 1e-4)
    _close(got.similarity_scores, want.similarity_scores, 1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classification_report_is_sklearns(seed):
    """The numpy report equals scikit-learn's text, classes without
    predictions or without samples (zero_division=0) included."""
    from sklearn.metrics import classification_report

    rng = np.random.default_rng(seed)
    n = [5, 40, 200][seed]
    labels = rng.integers(0, 5, n)  # classes 5, 6 have no samples
    preds = rng.integers(1, 7, n)   # class 0 is never predicted
    want = classification_report(labels, preds, labels=list(range(7)),
                                 target_names=list(EMOTIONS),
                                 zero_division=0)
    assert EV.classification_report(labels, preds, list(EMOTIONS)) == want
    cm = EV.confusion_matrix(labels, preds, 7)
    assert cm.sum() == n and cm[5:].sum() == 0


def test_compare_models_matches_reference(bb, ref_models, root, capsys):
    pp, pcfg, ptok = bb[1]
    ref, port = _models(bb, ref_models, seed=7)
    ref.update_emotion_embeddings()
    port.update_emotion_embeddings()
    want = RCMP.compare_models(ref, ref_models[1], _eval_loader(root, RD),
                               plots=False)
    want_out = capsys.readouterr().out
    got = CMP.compare_models(
        port, T.ZeroShotEmotionRecognition(pp, pcfg, ptok, policy=FP32),
        _eval_loader(root, D), plots=False)
    assert capsys.readouterr().out == want_out
    assert set(got) == set(want) == {
        "zero_shot_accuracy_avg", "adapter_accuracy_avg",
        "zero_shot_accuracy_all", "adapter_accuracy_all"}
    for key in want:
        assert got[key] == pytest.approx(want[key])


def test_t_checkpoints_cross_both_ways(tmp_path):
    p = _adapters(8)
    tp = to_torch(p)
    CK.save_t_adapters(str(tmp_path / "port.pt"), tp)
    back = RCK.load_t_adapters(str(tmp_path / "port.pt"))
    RCK.save_t_adapters(str(tmp_path / "ref.pt"), p)
    mine = CK.load_t_adapters(str(tmp_path / "ref.pt"), device="cpu")
    for name in ("visual", "text"):
        for layer in ("fc1", "fc2"):
            for key in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    np.asarray(back[name][layer][key]),
                    np.asarray(p[name][layer][key]))
                torch.testing.assert_close(mine[name][layer][key],
                                           tp[name][layer][key], atol=0,
                                           rtol=0)
    # strict T load: both adapters required; a V file (with context)
    # qualifies and its context adapter is dropped
    CK.save_v_adapters(str(tmp_path / "v.pt"), {"visual": tp["visual"],
                                                "context": tp["text"]})
    for load in (CK.load_t_adapters, RCK.load_t_adapters):
        with pytest.raises(ValueError, match="missing"):
            load(str(tmp_path / "v.pt"))
    CK.save_v_adapters(str(tmp_path / "v3.pt"), {**tp, "context": tp["text"]})
    assert set(CK.load_t_adapters(str(tmp_path / "v3.pt"),
                                  device="cpu")) == {"visual", "text"}
    assert set(RCK.load_v_adapters(str(tmp_path / "v3.pt"))) == {
        "visual", "text", "context"}
    with pytest.raises(ValueError, match="must contain"):
        CK.save_t_adapters(str(tmp_path / "x.pt"), {"visual": tp["visual"]})


def _tiny_cli(monkeypatch, bb):
    """Point the port's CLI plumbing at the tiny backbone."""
    from vlm_clip_tpu_torch.cli import common

    _, (pp, pcfg, ptok) = bb
    monkeypatch.setattr(common, "load_backbone",
                        lambda *a, **k: (pp, pcfg))
    monkeypatch.setattr(common, "make_tokenizer", lambda cfg: ptok)


def test_cli_compare_t_on_cpu(bb, root, monkeypatch, tmp_path, capsys):
    from vlm_clip_tpu_torch.cli import compare_t

    _tiny_cli(monkeypatch, bb)
    monkeypatch.setenv("VLM_CLIP_LOG_DIR", str(tmp_path / "logs"))
    F.reset_launch_counts()
    res = compare_t.main(["--train-dir", root, "--test-dir", root,
                          "--batch-size", "8", "--num-epochs", "2",
                          "--bottleneck-dim", str(BOTTLENECK),
                          "--no-plots", "--device", "cpu"])
    assert "Performance Comparison" in capsys.readouterr().out
    assert len(res.pop("losses")) == 2
    assert set(res) == {"zero_shot_accuracy_avg", "adapter_accuracy_avg",
                        "zero_shot_accuracy_all", "adapter_accuracy_all"}
    assert all(0.0 <= v <= 1.0 for v in res.values())
    assert not any(F.launch_counts().values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        compare_t.main(["--train-dir", root, "--test-dir", root])


@pytest.mark.parametrize("with_ckpt", [True, False])
def test_cli_predict_image_on_cpu(bb, monkeypatch, tmp_path, with_ckpt):
    """One image through the port's CLI (default BF16 policy, the
    adapters from a T file the port wrote, loaded the non-strict way the
    reference CLI loads them) against the reference CLI's own steps. In
    bf16 the two frameworks round at other places, and a softmax of 100x
    cosine magnifies that, so the check is on the cosines behind the
    probabilities: log p / 100 up to a constant, within 4e-3 (one bf16
    ulp of a unit-norm feature)."""
    from vlm_clip_tpu_torch.cli import predict_image

    _tiny_cli(monkeypatch, bb)
    (rp, rcfg, rtok), _ = bb
    img = tmp_path / "face.jpg"
    img.write_bytes(jpeg_bytes(3, (48, 40)))
    argv = [str(img), "--device", "cpu", "--plot-out",
            str(tmp_path / "p.png")]
    if with_ckpt:
        ckpt = str(tmp_path / "t.pt")
        CK.save_t_adapters(ckpt, to_torch(_adapters(9)))
        argv += ["--adapter-ckpt", ckpt]
        ref = RT.CLIPAdapterT(rp, rcfg, rtok)
        ref.adapter_params.update(RCK.load_v_adapters(ckpt))
        ref.update_emotion_embeddings()
    else:
        ref = RT.ZeroShotEmotionRecognition(rp, rcfg, rtok)
    got = predict_image.main(argv)
    px = RP.preprocess_host(str(img), 32)[None]
    want = np.asarray(ref.predict(jnp.asarray(px)))[0]
    assert got.shape == (7,)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-5)

    def cosines(p):
        s = np.log(np.asarray(p, np.float64)) / 100.0
        return s - s.mean()

    np.testing.assert_allclose(cosines(got), cosines(want), atol=4e-3)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read().decode()))
    conn.close()
    return out


def test_serve_t_adapter_classify_matches_reference(bb, tmp_path):
    """t-adapter mode: the strict T load, then /classify over HTTP equals
    the reference's build_predict_fn on the same checkpoint."""
    ref_bb, port_bb = bb
    ckpt = str(tmp_path / "t.pt")
    RCK.save_t_adapters(ckpt, _adapters(10))
    ref_fn, ref_mode, _ = RS.build_predict_fn(
        "tiny", adapter_ckpt=ckpt, backbone=ref_bb, policy=RFP32,
        max_batch=4)
    F.reset_launch_counts()
    fn, mode, cfg = S.build_predict_fn("tiny", adapter_ckpt=ckpt,
                                       backbone=port_bb, policy=FP32,
                                       max_batch=4)
    assert mode == ref_mode == "t-adapter"
    u8 = np.random.default_rng(0).integers(0, 255, (4, 32, 32, 3), np.uint8)
    np.testing.assert_allclose(fn(u8), np.asarray(ref_fn(u8)), atol=1e-4)
    classifier = S.BatchingClassifier(fn, cfg.vision.image_size,
                                      max_batch=4, window_ms=5.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), S.make_handler(
        classifier, "tiny"))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        body = jpeg_bytes(11)
        status, out = _request(srv.server_address[1], "POST", "/classify",
                               body)
    finally:
        srv.shutdown()
        srv.server_close()
    from PIL import Image

    u8 = np.zeros((4, 32, 32, 3), np.uint8)
    u8[0] = RP.load_and_resize(Image.open(io.BytesIO(body)), 32)
    assert status == 200
    probs = [out["probs"][e] for e in EMOTIONS]
    np.testing.assert_allclose(probs, np.asarray(ref_fn(u8))[0], atol=1e-4)
    assert out["label"] == EMOTIONS[int(np.argmax(probs))]
    assert not any(F.launch_counts().values())  # CPU: plain versions
    # refusals: a file without the text adapter; a T file where a V one
    # is asked for (pipeline V's strict load: tests/test_torch_pipeline_v.py)
    RCK.save_v_adapters(str(tmp_path / "v.pt"), {"visual": _adapters(10)[
        "visual"]})
    with pytest.raises(ValueError, match="missing"):
        S.build_predict_fn("tiny", adapter_ckpt=str(tmp_path / "v.pt"),
                           backbone=port_bb, policy=FP32)
    with pytest.raises(ValueError, match="not a V checkpoint"):
        S.build_predict_fn("tiny", v_adapter_ckpt=ckpt, backbone=port_bb)


def test_plots_write_the_reference_files(bb, ref_models, root, tmp_path):
    """The copied plot functions write the reference's pngs (same names)
    from an EvalResult; matplotlib and seaborn are imported only here."""
    from vlm_clip_tpu.eval import plots as RPL
    from vlm_clip_tpu_torch.eval import plots as PL

    _, port = _models(bb, ref_models, seed=11)
    res = EV.evaluate_model(port, _eval_loader(root, D))
    n = 6  # a few images keep the prediction grids quick
    for mod, out in ((PL, tmp_path / "port"), (RPL, tmp_path / "ref")):
        out.mkdir()
        mod.plot_confusion_matrix(res.conf_matrix, "CM (Avg)",
                                  out_dir=str(out))
        mod.plot_class_similarities(res.similarity_scores, res.labels,
                                    "Sim (Avg)", out_dir=str(out))
        mod.visualize_predictions(res.image_paths[:n], res.labels[:n],
                                  res.predictions[:n], res.confidences[:n],
                                  title="Pred (Avg)", out_dir=str(out))
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names and names == sorted(p.name for p in
                                     (tmp_path / "ref").iterdir())
