"""The port's tensor-parallel partition rules and shard cuts
(parallel/sharding.py, ops/quant.shard_quantized, ops/nf4.shard_nf4),
in one process, against the JAX package.

- partition_specs: the reference's spec for every leaf, for the tiny
  CLIP tree and the tiny Qwen2.5-VL in its fp, 8h4 (fused q/k/v and
  gate/up, which match no rule and stay replicated, with an untied int4
  head), mixed, int4 and NF4 layouts, and with the tied embedding;
- the cuts: a column cut of an int8 or int4 weight is bit for bit the
  reference's quantize_weight of the cut fp weight (an int4 vocabulary
  shard re-padded to the tile grid), and an NF4 column cut holds the
  codes of quantizing the cut weight bit for bit; every row or column
  cut dequantizes to those rows or columns of the whole weight exactly,
  NF4 row shards of [2048, 512] (several second-level groups each) on
  the first and the last rank too;
- cut_params' decisions at model 2 and 4 (the GQA fallback: 2 kv heads
  replicate at model 4 and each rank picks the kv head of its q heads)
  and its head_dim map;
- split_stages' shapes and refusal; the entry points that default to
  the card.

The forwards across ranks are tests/test_torch_tensor_parallel.py and
tests/test_torch_model_parallel.py.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from _torch_port import port_qwen_config, to_torch
from helpers import tiny_clip_config
from test_qwen import tiny_cfgs
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu.ops import nf4 as RN
from vlm_clip_tpu.ops import quant as RQ
from vlm_clip_tpu.parallel import sharding as RS
from vlm_clip_tpu.vlm import qwen_convert as RC
from vlm_clip_tpu.vlm import qwen_model as RM
from vlm_clip_tpu_torch.ops import nf4 as PN
from vlm_clip_tpu_torch.ops import quant as PQ
from vlm_clip_tpu_torch.parallel import sharding as PS
from vlm_clip_tpu_torch.parallel import tensor_parallel as TP
from vlm_clip_tpu_torch.parallel.pipeline import split_stages
from vlm_clip_tpu_torch.vlm import qwen_model as PM


def _ref_specs(tree, rules):
    specs = RS.partition_specs(tree, rules)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {RS._path_str(kp): tuple(s) for kp, s in flat}


def _port_specs(tree, keys=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, keys + (k,)))
        return out
    return {"/".join(map(str, keys)): tuple(tree)}


def _qwen_trees():
    """{layout: (reference tree, port tree)} of the tiny Qwen2.5-VL."""
    cfg = tiny_cfgs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    fp = {"text": RM.init_text(k1, cfg.text),
          "vision": RM.init_vision(k2, cfg.vision)}
    trees = {
        "fp": fp,
        "8h4": RC.quantize_qwen_params(fp, 8, head_bits=4,
                                       fuse_decode=True),
        "mixed": RC.quantize_qwen_params(fp, RC.MIXED_DECODE_BITS,
                                         head_bits=4, fuse_decode=True),
        "int4": RC.quantize_qwen_params(fp, 4),
        "nf4": RC.quantize_qwen_params(fp, "nf4", head_bits="nf4"),
    }
    return cfg, {k: (v, to_torch(v)) for k, v in trees.items()}


@pytest.fixture(scope="module")
def qwen():
    return _qwen_trees()


def test_clip_partition_specs_match_reference():
    params = init_clip(jax.random.PRNGKey(0), tiny_clip_config())
    want = _ref_specs(params, RS.clip_param_rules())
    got = _port_specs(PS.partition_specs(to_torch(params),
                                         PS.clip_param_rules()))
    assert got == want
    assert got["vision/layers/attn/q/kernel"] == (None, None, "model")
    assert got["text/layers/mlp/fc2/kernel"] == (None, "model", None)
    assert PS.CLIP_PARAM_RULES == tuple((r, tuple(s)) for r, s in
                                        RS.CLIP_PARAM_RULES)


@pytest.mark.parametrize("layout", ["fp", "8h4", "mixed", "int4", "nf4"])
def test_qwen_partition_specs_match_reference(qwen, layout):
    _, trees = qwen
    ref, port = trees[layout]
    want = _ref_specs(ref, RS.qwen_param_rules())
    got = _port_specs(PS.partition_specs(port, PS.qwen_param_rules()))
    assert got == want
    assert got["text/embed_tokens"] == ()  # the tied embedding
    if layout in ("8h4", "mixed"):
        # the decode-fused linears match no rule: replicated
        assert got["text/layers/attn/qkv/qweight"] == ()
        assert got["text/layers/mlp/gateup/qweight"] == ()
        assert got["text/layers/attn/o/qweight"] == (None, "model", None)
        assert got["text/lm_head/qweight"] == (None, "model")
        assert got["text/lm_head/scale"] == ("model",)
    assert PS.QWEN_PARAM_RULES == tuple((r, tuple(s)) for r, s in
                                        RS.QWEN_PARAM_RULES)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("stacked", [False, True])
def test_quantized_column_cut_is_the_quantized_cut(bits, stacked):
    """The vocabulary-shard case: 1000 columns (an int4 weight padded to
    1024) cut in two, each re-padded to the tile grid."""
    rng = np.random.default_rng(bits)
    shape = (2, 64, 1000) if stacked else (64, 1000)
    w = rng.normal(size=shape).astype(np.float32)
    full = PQ.quantize_weight(torch.from_numpy(w), bits)
    for start, stop in ((0, 500), (500, 1000)):
        got = PQ.shard_quantized(full, -1, start, stop)
        cut = w[..., start:stop]
        if stacked:
            refs = [RQ.quantize_weight(jnp.asarray(c), bits) for c in cut]
            rq = np.stack([np.asarray(r.qweight) for r in refs])
            rs = np.stack([np.asarray(r.scale) for r in refs])
        else:
            r = RQ.quantize_weight(jnp.asarray(cut), bits)
            rq, rs = np.asarray(r.qweight), np.asarray(r.scale)
        np.testing.assert_array_equal(got.qweight.numpy(), rq)
        np.testing.assert_array_equal(got.scale.numpy(), rs)
        if bits == 4:
            assert got.qweight.shape[-1] == 1024  # 500 re-padded
            assert (got.logical_in, got.logical_out) == (64, 500)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_row_cut_dequantizes_to_the_rows(bits):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(2, 96, 40)).astype(np.float32))
    full = PQ.quantize_weight(w, bits)
    whole = torch.stack([PQ.dequantize_weight(full.map(lambda t: t[i]))
                         for i in range(2)])
    for start, stop in ((0, 48), (48, 96)):
        got = PQ.shard_quantized(full, -2, start, stop)
        deq = torch.stack([PQ.dequantize_weight(got.map(lambda t: t[i]))
                           for i in range(2)])
        assert torch.equal(deq, whole[:, start:stop])
    with pytest.raises(ValueError, match="row pairs"):
        PQ.shard_quantized(PQ.quantize_weight(w, 4), -2, 1, 49)


def test_nf4_cuts():
    """NF4: the column cut's codes are quantize_nf4's of the cut weight
    (the double-quantized absmax is global, so the shard keeps the
    whole second-level scales and its place in them); row cuts on block
    boundaries; both dequantize to the whole weight's rows or columns
    exactly; a stacked weight cuts per layer the same."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(256, 96)).astype(np.float32)
    full = PN.quantize_nf4(torch.from_numpy(w))
    whole = PN.dequantize_nf4(full)
    for start, stop in ((0, 48), (48, 96)):
        got = PN.shard_nf4(full, -1, start, stop)
        ref = RN.quantize_nf4(jnp.asarray(w[:, start:stop]))
        np.testing.assert_array_equal(got.qweight.numpy(),
                                      np.asarray(ref.qweight))
        assert torch.equal(PN.dequantize_nf4(got), whole[:, start:stop])
    for start, stop in ((0, 128), (128, 256)):
        got = PN.shard_nf4(full, -2, start, stop)
        assert torch.equal(PN.dequantize_nf4(got), whole[start:stop])
        x = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32))
        assert torch.allclose(PN.nf4_matmul(x, got),
                              x @ whole[start:stop], atol=1e-5)
    with pytest.raises(ValueError, match="block"):
        PN.shard_nf4(full, -2, 32, 96)
    stacked = PN.quantize_nf4_stacked(torch.from_numpy(
        rng.normal(size=(2, 128, 64)).astype(np.float32)))
    cut = PN.shard_nf4(PN.shard_nf4(stacked, -1, 32, 64), -2, 64, 128)
    for i in range(2):
        lay = stacked.map(lambda t: t[i])
        assert torch.equal(PN.dequantize_nf4(cut.map(lambda t: t[i])),
                           PN.dequantize_nf4(lay)[64:, 32:])


@pytest.mark.parametrize("model", [2, 4])
def test_nf4_row_cuts_span_groups(model):
    """A row cut of [2048, 512] (an o/down shard at a 3B-like width): each
    shard holds several 256-element second-level groups, so rank 0's shard
    (rows from 0, columns whole) must read its groups' scales by place as
    every other shard does."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(2048, 512)).astype(np.float32)
    full = PN.quantize_nf4(torch.from_numpy(w))
    whole = PN.dequantize_nf4(full)
    share = 2048 // model
    x = torch.from_numpy(rng.normal(size=(3, share)).astype(np.float32))
    for r in (0, model - 1):
        start, stop = r * share, (r + 1) * share
        got = PN.shard_nf4(full, -2, start, stop)
        assert got.absmax_q.numel() > 2 * PN.NF4_DQ_GROUP
        assert torch.equal(PN.dequantize_nf4(got), whole[start:stop])
        torch.testing.assert_close(PN.nf4_matmul(x, got),
                                   x @ whole[start:stop], atol=1e-4,
                                   rtol=1e-5)


def _kinds(tree):
    return {k: (v.kind if isinstance(v, TP.TPLinear) else None)
            for k, v in tree.items()}


@pytest.mark.parametrize("model", [2, 4])
def test_cut_params_decisions(qwen, model):
    cfg, trees = qwen
    pcfg = port_qwen_config(cfg)
    _, fp = trees["fp"]
    text = dict(fp["text"])
    text["lm_head"] = {"kernel": text["embed_tokens"].T.contiguous()}
    for r in range(model):
        sp = PS.cut_params({"text": text, "vision": fp["vision"]},
                           PS.qwen_param_rules(), {"model": model},
                           {"model": r}, PS.qwen_head_dims(pcfg))
        attn = _kinds(sp["text"]["layers"]["attn"])
        # 4 heads of 16, 2 kv heads: at model 4 k/v replicate
        kv = "column" if model == 2 else None
        assert attn == {"q": "column", "k": kv, "v": kv, "o": "row"}
        assert _kinds(sp["text"]["layers"]["mlp"]) == {
            "gate": "column", "up": "column", "down": "row"}
        assert sp["text"]["lm_head"].kind == "vocab"
        assert _kinds(sp["vision"]["blocks"]["attn"]) == {
            "qkv": None, "proj": "row"}
        h, nkv, pick = PM.local_heads(sp["text"]["layers"]["attn"],
                                      pcfg.text)
        assert (h, nkv) == (4 // model, 1)
        if model == 4:  # q heads 0,1 read kv head 0; 2,3 kv head 1
            assert pick == slice(r // 2, r // 2 + 1)
        q = sp["text"]["layers"]["attn"]["q"]
        assert (q.start, q.stop) == (r * 64 // model, (r + 1) * 64 // model)
        torch.testing.assert_close(
            q.inner["kernel"], text["layers"]["attn"]["q"]["kernel"][
                ..., q.start:q.stop], rtol=0, atol=0)
    # without a process group the sharded linears refuse to run
    with pytest.raises(RuntimeError, match="process group"):
        PM.linear(sp["text"]["layers"]["mlp"]["gate"].map(lambda t: t[0]),
                  torch.zeros(1, 64))


def test_cut_params_8h4_and_nf4_layouts(qwen):
    """8h4: the fused qkv/gateup replicate, o/down cut their rows, the
    int4 head its vocabulary (re-padded); NF4 at 64 hidden columns: o's
    32-row shares are not whole 64-row blocks, so o replicates and q's
    shard is gathered instead of kept local."""
    cfg, trees = qwen
    pcfg = port_qwen_config(cfg)
    _, t = trees["8h4"]
    sp = PS.cut_params(t, PS.qwen_param_rules(), {"model": 2},
                       {"model": 1}, PS.qwen_head_dims(pcfg))
    assert _kinds(sp["text"]["layers"]["attn"]) == {"qkv": None,
                                                    "o": "row"}
    assert _kinds(sp["text"]["layers"]["mlp"]) == {"gateup": None,
                                                   "down": "row"}
    head = sp["text"]["lm_head"]
    assert head.kind == "vocab" and head.inner.logical_out == \
        cfg.text.vocab_size // 2
    _, t = trees["nf4"]
    sp = PS.cut_params(t, PS.qwen_param_rules(), {"model": 2},
                       {"model": 0}, PS.qwen_head_dims(pcfg))
    attn = _kinds(sp["text"]["layers"]["attn"])
    assert attn["o"] is None and attn["q"] == "vocab"


def test_head_dim_is_a_prefix_map(qwen):
    """head_dim maps path prefixes to head widths (the longest wins, ""
    every path); an attention that no prefix names is refused rather
    than cut without the whole-heads check."""
    cfg, trees = qwen
    pcfg = port_qwen_config(cfg)
    _, fp = trees["fp"]
    args = (PS.qwen_param_rules(), {"model": 2}, {"model": 1})
    by_tree = PS.cut_params(fp, *args, PS.qwen_head_dims(pcfg))
    every = PS.cut_params({"text": fp["text"]}, *args,
                          {"": pcfg.text.head_dim})
    q, q2 = (t["text"]["layers"]["attn"]["q"] for t in (by_tree, every))
    assert (q.start, q.stop) == (q2.start, q2.stop)
    with pytest.raises(ValueError, match="names no prefix"):
        PS.cut_params(fp, *args, {"vision": pcfg.vision.head_dim})


def test_split_stages_shapes():
    cfg = port_qwen_config(tiny_cfgs()).text
    cfg = dataclasses.replace(cfg, num_layers=4)
    params = PM.init_text(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    staged = split_stages(params, 2)
    q = staged["layers"]["attn"]["q"]["kernel"]
    assert q.shape[:2] == (2, 2)
    assert torch.equal(q.reshape(4, *q.shape[2:]),
                       params["layers"]["attn"]["q"]["kernel"])
    with pytest.raises(ValueError, match="not divisible"):
        split_stages(params, 3)


def test_entry_points_default_to_the_card():
    """The public init and convert functions place on the card unless
    the caller asks for the CPU, as the reference places on its default
    device."""
    from vlm_clip_tpu_torch.cli import validate_parity
    from vlm_clip_tpu_torch.models import model_m, model_t, model_v
    from vlm_clip_tpu_torch.train import trainer_t
    from vlm_clip_tpu_torch.vlm import qwen_convert

    fns = [model_m.init_m_adapters, model_t.init_t_adapters,
           model_v.init_v_adapters, qwen_convert.convert_qwen_text,
           qwen_convert.convert_qwen_vision, qwen_convert.convert_qwen_vl,
           PM.init_kv_cache, PM.init_text, PM.init_vision,
           trainer_t.FeatureCache.__init__, validate_parity.validate_qwen]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__qualname__
