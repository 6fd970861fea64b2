"""The EMOTIC workload in the port against the JAX package: the loaders,
the .mat converter (byte for byte), the batch normalization, mAP against
sklearn (the reference's), the head's forward, loss and gradients, two
epochs of training, the head file in both directions, the evaluation and
cli/train_emotic on the CPU. Same numpy inputs, the JAX package's tiny
random CLIP bridged to the port, FP32 on both sides.

Tolerances: loaders, converter and head files exact; normalization
1e-6; mAP 1e-12 (both float64 over the same operations); the head's
logits, loss and gradients 1e-5 (relative to the largest element for
gradients); per-epoch training losses 1e-4 relative; eval mAP 1e-6.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.data import emotic as RE
from vlm_clip_tpu.data import rafdb as RD
from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
from vlm_clip_tpu.eval import emotic as REV
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu.train import trainer_emotic as RT
from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data import emotic as E
from vlm_clip_tpu_torch.data import rafdb as D
from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer
from vlm_clip_tpu_torch.eval import emotic as EV
from vlm_clip_tpu_torch.ops import fused_adapter as F
from vlm_clip_tpu_torch.train import trainer_emotic as PT

from _torch_port import port_clip_config, to_torch
from helpers import tiny_clip_config
from test_emotic_video import _obj

BOTTLENECK = 16


@pytest.fixture(scope="module")
def tiny():
    """(ref cfg, port cfg, ref params, port params)."""
    cfg = tiny_clip_config()
    params = init_clip(jax.random.PRNGKey(0), cfg)
    return cfg, port_clip_config(cfg), params, to_torch(params)


def _arrays(n, size, seed):
    rng = np.random.default_rng(seed)
    cat = (rng.random((n, 26)) > 0.8).astype(np.float32)
    cat[np.arange(n), np.arange(n) % 26] = 1.0
    return (rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, 16, 16, 3), dtype=np.uint8), cat,
            (rng.random((n, 3)) * 10).astype(np.float32))


def _write_split(d, split, n, size, seed):
    for name, arr in zip(("context", "body", "cat", "cont"),
                         _arrays(n, size, seed)):
        np.save(d / f"{split}_{name}_arr.npy", arr)


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("context", "body", "cat", "cont", "valid"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# -- loaders ------------------------------------------------------------------

def test_categories_and_one_hot_match_reference():
    assert E.EMOTIC_CATEGORIES == RE.EMOTIC_CATEGORIES
    assert (E.CONTEXT_NORM, E.BODY_NORM) == (RE.CONTEXT_NORM, RE.BODY_NORM)
    for cats in ([], ["Anger"], ["Peace", "Happiness", "Yearning"],
                 list(E.EMOTIC_CATEGORIES)):
        np.testing.assert_array_equal(E.cat_to_one_hot(cats),
                                      RE.cat_to_one_hot(cats))


@pytest.mark.parametrize("batch_size", [4, 5])
def test_pre_dataset_and_collate_match_reference(tmp_path, batch_size):
    _write_split(tmp_path, "train", 10, 24, seed=1)
    ds = E.EmoticPreDataset.from_dir(str(tmp_path), "train")
    rds = RE.EmoticPreDataset.from_dir(str(tmp_path), "train")
    assert len(ds) == len(rds) == 10
    for i in (0, 9):
        for a, b in zip(ds[i], rds[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    got = list(D.BatchLoader(ds, batch_size, collate_fn=E.emotic_collate))
    want = list(RD.BatchLoader(rds, batch_size,
                               collate_fn=RE.emotic_collate))
    _batches_equal(got, want)
    assert got[-1].valid.sum() == 10 - batch_size * (len(got) - 1)
    assert got[-1].size == batch_size  # the tail padded


def test_csv_dataset_matches_reference(tmp_path):
    from PIL import Image

    (tmp_path / "mscoco").mkdir()
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 255, (96, 80, 3), dtype=np.uint8)
                    ).save(tmp_path / "mscoco" / "a.jpg")
    df = pd.DataFrame([{
        "Index": 0, "Folder": "mscoco", "Filename": "a.jpg",
        "Image Size": "[96, 80]", "BBox": "[10, 10, 60, 90]",
        "Categorical_Labels": "['Anger', 'Fatigue']",
        "Continuous_Labels": "[5.0, 6.0, 7.0]",
        "Gender": "Male", "Age": "Adult"}])
    got = E.EmoticCSVDataset(df, data_src=str(tmp_path))[0]
    want = RE.EmoticCSVDataset(df, data_src=str(tmp_path))[0]
    assert got[0].shape == (224, 224, 3) and got[1].shape == (128, 128, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _mat_split(split):
    """A hand-built Annotations.mat split (train or test layout): three
    images, one missing, one person without categories."""
    def row(items):
        a = np.empty((1, len(items)), object)
        for i, it in enumerate(items):
            a[0, i] = it
        return a

    def cats(cs):
        return _obj(np.array([_obj(c) for c in cs], object))

    def conts(vs):
        return _obj(np.array([np.float64(v) for v in vs], object))

    def person(bbox, cs, vs):
        box = np.asarray(bbox, np.float64)[None]
        tail = [np.asarray(["Male"]), np.asarray(["Adult"])]
        if split == "train":
            return [box, cats(cs), conts(vs)] + tail
        n_ann = 2 if cs else 0
        return [box, row([cats(cs)] * n_ann), cats(cs),
                row([conts(vs)] * n_ann), conts(vs)] + tail

    def example(fname, persons):
        size = _obj(np.array([[np.asarray([[50]]), np.asarray([[40]])]],
                             object))
        return [np.asarray([fname]), np.asarray(["mscoco"]), size, None,
                row(persons)]

    examples = [
        example("x.jpg", [person([5, 5, 30, 45], ["Anger"], [5, 5, 5])]),
        example("y.jpg", [person([0, 0, 40, 50], ["Peace", "Happiness"],
                                 [7, 3, 2]),
                          person([0, 0, 10, 10], [], [1, 1, 1])]),
        example("missing.jpg", [person([0, 0, 10, 10], ["Fear"],
                                       [2, 2, 2])]),
    ]
    m = np.empty((1, len(examples)), object)
    for i, ex in enumerate(examples):
        m[0, i] = ex
    return m


@pytest.mark.parametrize("split", ["train", "test"])
def test_mat_converter_byte_equal_to_reference(tmp_path, split):
    """prepare_data on a synthetic .mat: the csv and every npy file equal
    the reference's byte for byte (cv2's resize in both)."""
    pytest.importorskip("cv2")
    from PIL import Image

    from vlm_clip_tpu.data import emotic_mat as RM
    from vlm_clip_tpu_torch.data import emotic_mat as PM

    img_root = tmp_path / "emotic"
    (img_root / "mscoco").mkdir(parents=True)
    rng = np.random.default_rng(2)
    for name in ("x.jpg", "y.jpg"):
        Image.fromarray(rng.integers(0, 255, (50, 40, 3), dtype=np.uint8)
                        ).save(img_root / "mscoco" / name)
    outs = []
    for tag, mod in (("port", PM), ("ref", RM)):
        out = tmp_path / tag
        mod.prepare_data(_mat_split(split), str(img_root), str(out),
                         dataset_type=split, generate_npy=True)
        outs.append(out)
    names = [f"{split}.csv"] + [f"{split}_{n}_arr.npy"
                                for n in ("context", "body", "cat", "cont")]
    for name in names:
        assert (outs[0] / name).read_bytes() == (outs[1] / name).read_bytes()
    assert len(pd.read_csv(outs[0] / f"{split}.csv")) == 2
    assert np.load(outs[0] / f"{split}_context_arr.npy").shape == \
        (2, 224, 224, 3)


def test_normalize_emotic_batch_matches_reference():
    ctx, body, _, _ = _arrays(3, 24, seed=4)
    got = E.normalize_emotic_batch(ctx, body)
    want = RE.normalize_emotic_batch(jnp.asarray(ctx), jnp.asarray(body))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


# -- mAP ----------------------------------------------------------------------

def _map_case(kind, seed):
    rng = np.random.default_rng(seed)
    n = 57
    labels = (rng.random((n, 26)) > 0.7).astype(np.float32)
    if kind == "random":
        scores = rng.normal(size=(n, 26)).astype(np.float32)
    elif kind == "ties":  # a handful of distinct values: heavy ties
        scores = rng.integers(0, 4, (n, 26)).astype(np.float32) / 4
    else:  # all tied in a column, and a column of one positive
        scores = np.round(rng.random((n, 26)), 1).astype(np.float32)
        scores[:, 3] = 0.5
        labels[:, 5] = 0.0
        labels[7, 5] = 1.0
    labels[:, 2] = 0.0  # a class with no positive
    return scores, labels


@pytest.mark.parametrize("kind", ["random", "ties", "degenerate"])
def test_mean_average_precision_matches_sklearn(kind):
    scores, labels = _map_case(kind, seed=len(kind))
    m, aps = EV.mean_average_precision(scores, labels)
    rm, raps = REV.mean_average_precision(scores, labels)
    assert np.isnan(aps[2]) and np.isnan(raps[2])
    np.testing.assert_allclose(aps, raps, atol=1e-12, rtol=0)
    assert abs(m - rm) <= 1e-12


# -- the head: forward, loss, gradients ---------------------------------------

def _head_inputs(seed=5, B=8, P=32):
    rng = np.random.default_rng(seed)

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)
                ).astype(np.float32)

    valid = np.ones((B,), bool)
    valid[-2:] = False
    return (unit(rng.normal(size=(B, P))), unit(rng.normal(size=(26, P))),
            (rng.random((B, 26)) > 0.7).astype(np.float32),
            rng.random((B, 3)).astype(np.float32), valid)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("with_vad", [True, False])
def test_head_forward_loss_and_gradients_match_reference(with_vad):
    feats, cat_emb, cats, vad, valid = _head_inputs()
    rhead = RT.init_emotic_head(jax.random.PRNGKey(3), 32, BOTTLENECK,
                                with_vad)
    head = to_torch(rhead)
    for p in tree_leaves(head):
        p.requires_grad_(True)
    args = (0.2, 100.0)
    rlog, rvad = RT.emotic_forward(rhead, jnp.asarray(feats),
                                   jnp.asarray(cat_emb), *args)
    calls = []
    real = F.feature_adapter_blend_fused
    with pytest.MonkeyPatch.context() as mp:  # the route: K6's fused op
        mp.setattr(F, "feature_adapter_blend_fused",
                   lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
        plog, pvad = PT.emotic_forward(head, torch.from_numpy(feats),
                                       torch.from_numpy(cat_emb), *args)
    assert calls == [(8, 32)]
    np.testing.assert_allclose(plog.detach().numpy(), np.asarray(rlog),
                               atol=1e-5 * 100, rtol=1e-5)
    assert (pvad is None) == (rvad is None) == (not with_vad)
    if with_vad:
        np.testing.assert_allclose(pvad.detach().numpy(), np.asarray(rvad),
                                   atol=1e-5, rtol=1e-5)

    rloss, rgrads = jax.value_and_grad(RT.emotic_loss_fn)(
        rhead, jnp.asarray(feats), jnp.asarray(cats), jnp.asarray(vad),
        jnp.asarray(valid), jnp.asarray(cat_emb), 0.2, 100.0, 0.5)
    loss = PT.emotic_loss_fn(head, torch.from_numpy(feats),
                             torch.from_numpy(cats), torch.from_numpy(vad),
                             torch.from_numpy(valid),
                             torch.from_numpy(cat_emb), 0.2, 100.0, 0.5)
    loss.backward()
    assert abs(loss.item() - float(rloss)) <= 1e-5 * abs(float(rloss))
    got = {k: v.grad for k, v in _flat(head).items()}
    want = _flat(jax.tree.map(np.asarray, rgrads))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (k, err)


def test_sigmoid_bce_is_optax_at_large_logits():
    import optax

    x = np.asarray([-150.0, -30.0, -1.0, 0.0, 0.5, 40.0, 120.0], np.float32)
    for y in (0.0, 1.0, 0.3):
        got = PT.sigmoid_binary_cross_entropy(torch.from_numpy(x),
                                              torch.full((7,), y))
        want = optax.sigmoid_binary_cross_entropy(jnp.asarray(x), y)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


# -- training, head files, evaluation -----------------------------------------

def test_train_emotic_matches_reference(tiny, monkeypatch, tmp_path):
    """Two epochs of 30 items at B=8 (a masked tail) from the same head:
    per-epoch losses within 1e-4 relative; the trained heads' files load
    in the other package; the eval mAP with the trained head within 1e-6
    of the reference's."""
    cfg, pcfg, rparams, pparams = tiny
    _write_split(tmp_path, "train", 30, cfg.vision.image_size, seed=8)
    ds = E.EmoticPreDataset.from_dir(str(tmp_path), "train")
    rds = RE.EmoticPreDataset.from_dir(str(tmp_path), "train")
    rhead0 = RT.init_emotic_head(jax.random.PRNGKey(9), cfg.projection_dim,
                                 BOTTLENECK)
    phead0 = to_torch(rhead0)
    # fresh copies: the reference's step donates its params
    monkeypatch.setattr(RT, "init_emotic_head",
                        lambda *a, **k: jax.tree.map(jnp.array, rhead0))
    monkeypatch.setattr(PT, "init_emotic_head", lambda *a, **k: phead0)
    kw = dict(num_epochs=2, batch_size=8, learning_rate=3e-3,
              bottleneck=BOTTLENECK, seed=1)
    rhead, rlosses = RT.train_emotic(rparams, cfg, RHash(cfg.text.vocab_size),
                                     rds, policy=RFP32, **kw)
    seconds = []
    head, losses = PT.train_emotic(pparams, pcfg,
                                   HashTokenizer(pcfg.text.vocab_size), ds,
                                   policy=FP32, epoch_seconds=seconds, **kw)
    assert len(losses) == len(seconds) == 2 and losses[1] < losses[0]
    np.testing.assert_allclose(losses, rlosses, rtol=1e-4, atol=0)

    # head files cross between the packages
    PT.save_emotic_head(str(tmp_path / "port.npz"), head)
    RT.save_emotic_head(str(tmp_path / "ref.npz"), rhead)
    from_port = RT.load_emotic_head(str(tmp_path / "port.npz"))
    from_ref = PT.load_emotic_head(str(tmp_path / "ref.npz"), device="cpu")
    for k, v in _flat(head).items():
        np.testing.assert_array_equal(np.asarray(_flat(from_port)[k]),
                                      v.detach().numpy())
    for k, v in _flat(jax.tree.map(np.asarray, rhead)).items():
        np.testing.assert_array_equal(_flat(from_ref)[k].numpy(), v)

    _write_split(tmp_path, "test", 13, cfg.vision.image_size, seed=10)
    tds = E.EmoticPreDataset.from_dir(str(tmp_path), "test")
    rtds = RE.EmoticPreDataset.from_dir(str(tmp_path), "test")
    for adapter in (None, "trained"):
        got = EV.evaluate_emotic(
            pparams, pcfg, HashTokenizer(pcfg.text.vocab_size),
            D.BatchLoader(tds, 4, collate_fn=E.emotic_collate),
            adapter_params=from_ref if adapter else None, policy=FP32)
        want = REV.evaluate_emotic(
            rparams, cfg, RHash(cfg.text.vocab_size),
            RD.BatchLoader(rtds, 4, collate_fn=RE.emotic_collate),
            adapter_params=rhead if adapter else None, policy=RFP32)
        assert got["num_samples"] == want["num_samples"] == 13
        assert abs(got["mAP"] - want["mAP"]) <= 1e-6, adapter
        assert got["per_class_ap"].keys() == want["per_class_ap"].keys()


def test_encode_all_contexts_matches_reference(tiny):
    cfg, pcfg, rparams, pparams = tiny

    class _DS:
        def __init__(self, arr):
            self.arr = arr

        def __len__(self):
            return len(self.arr)

        def __getitem__(self, i):
            return (self.arr[i],)

    ctx = _arrays(11, cfg.vision.image_size, seed=12)[0]
    got = PT.encode_all_contexts(pparams, pcfg, _DS(ctx), batch_size=4,
                                 policy=FP32)
    want = RT.encode_all_contexts(rparams, cfg, _DS(ctx), batch_size=4,
                                  policy=RFP32)
    assert got.shape == (11, cfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_cli_train_emotic_on_cpu(tiny, tmp_path, monkeypatch):
    """cli/train_emotic end to end on --device cpu: trains, saves a head
    the reference loads, evaluates the test split; --device cuda without a
    card is an error."""
    import vlm_clip_tpu_torch.cli.common as common
    from vlm_clip_tpu_torch.cli.train_emotic import main

    cfg, pcfg, _, pparams = tiny
    monkeypatch.setattr(common, "load_backbone",
                        lambda *a, **k: (pparams, pcfg))
    monkeypatch.setattr(common, "make_tokenizer",
                        lambda *a, **k: HashTokenizer(pcfg.text.vocab_size))
    for split, n in (("train", 12), ("test", 6)):
        _write_split(tmp_path, split, n, cfg.vision.image_size, seed=n)
    out = tmp_path / "head.npz"
    argv = ["--data-dir", str(tmp_path), "--num-epochs", "2",
            "--batch-size", "8", "--bottleneck", "16", "--output", str(out)]
    res = main(argv + ["--device", "cpu"])
    assert out.exists() and len(res["losses"]) == 2
    assert res["eval"]["num_samples"] == 6 and np.isfinite(res["eval"]["mAP"])
    head = RT.load_emotic_head(str(out))
    assert set(head) == {"visual", "vad"}
    assert head["vad"]["kernel"].shape == (cfg.projection_dim, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(argv)
