"""vlm_clip_tpu_torch.vlm against vlm_clip_tpu.vlm on the tiny Qwen2.5-VL
of tests/test_qwen.py: text and vision forwards, cached routes, greedy
generation token for token, sampling, conversion, quantization presets,
preprocessing, the tokenizer, the extractors and cli/bench_decode. The
same params (the JAX package's random init, bridged) and numpy inputs go
to both; fp32 throughout."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import port_qwen_config, tiny_qwen
from test_qwen import IMG_TOK, VIS_START, hf_model  # noqa: F401
from vlm_clip_tpu.vlm import qwen_convert as RC
from vlm_clip_tpu.vlm import qwen_model as RM
from vlm_clip_tpu.vlm import qwen_process as RP
from vlm_clip_tpu.vlm import sampling as RS
from vlm_clip_tpu.vlm.qwen import QwenVLGenerator as RGen
from vlm_clip_tpu_torch.bridge import tree_to_torch
from vlm_clip_tpu_torch.ops import quant as PQ
from vlm_clip_tpu_torch.vlm import qwen_convert as PC
from vlm_clip_tpu_torch.vlm import qwen_model as PM
from vlm_clip_tpu_torch.vlm import qwen_process as PP
from vlm_clip_tpu_torch.vlm import sampling as PS
from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator as PGen

GRID = (1, 8, 8)
IDS = np.asarray([1, 2, VIS_START] + [IMG_TOK] * 16 + [3, 4, 5], np.int64)


@pytest.fixture(scope="module")
def tiny():
    return tiny_qwen(7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask(T, S=None):
    S = S or T
    m = np.where(np.arange(S)[None] <= np.arange(T)[:, None], 0.0,
                 np.finfo(np.float32).min).astype(np.float32)
    return m[None, None]


def _patches(seed, n=64):
    in_dim = 3 * 2 * 4 ** 2  # C * temporal patch * patch**2 of tiny_cfgs
    return np.random.default_rng(seed).normal(size=(n, in_dim)).astype(
        np.float32)


def _vins(patches, grid=GRID):
    from test_qwen import tiny_cfgs

    cfg = tiny_cfgs()
    return (RP.vision_inputs_from_patches(patches, grid, cfg.vision),
            PP.vision_inputs_from_patches(patches, grid,
                                          port_qwen_config(cfg).vision))


# -- text -------------------------------------------------------------------

def test_text_forward_matches_reference(tiny):
    cfg, pcfg, jp, pp = tiny
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 200, (2, 9))
    emb = np.asarray(jp["text"]["embed_tokens"])[ids]
    pos = np.broadcast_to(np.arange(9), (3, 2, 9))
    want, _ = RM.text_forward(jp["text"], jnp.asarray(emb), jnp.asarray(pos),
                              cfg.text, jnp.asarray(_mask(9)))
    got, _ = PM.text_forward(pp["text"], _t(emb), _t(pos), pcfg.text,
                             _t(_mask(9)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("route", ["dense", "split"])
@pytest.mark.parametrize("quant", [False, True])
def test_cached_prefill_and_decode_match_reference(tiny, monkeypatch, route,
                                                   quant):
    """Prefill into the cache, then one canonical-mask decode step: both
    routes of the port (dense write-then-attend, split old + fresh
    columns) against the reference's; logits and written rows."""
    cfg, pcfg, jp, pp = tiny
    if route == "split":
        monkeypatch.setattr(PM, "_DENSE_CACHE_ROUTE_MAX_BYTES", 0)
    B, T, S = 2, 7, 24
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(B, T, 64)).astype(np.float32)
    emb1 = rng.normal(size=(B, 1, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (3, B, T)).copy()
    pos1 = np.full((3, 1, 1), T)
    rc = RM.init_kv_cache(cfg.text, B, S, jnp.float32, quantized=quant)
    pc = PM.init_kv_cache(pcfg.text, B, S, torch.float32, quantized=quant,
                          device="cpu")
    k_ptr = pc.k.data_ptr()
    w0, rc = RM.text_forward(jp["text"], jnp.asarray(emb), jnp.asarray(pos),
                             cfg.text, jnp.asarray(_mask(T, S)), rc,
                             jnp.int32(0), last_only=True)
    g0, pc = PM.text_forward(pp["text"], _t(emb), _t(pos), pcfg.text,
                             _t(_mask(T, S)), pc, 0, last_only=True)
    w1, rc = RM.text_forward(jp["text"], jnp.asarray(emb1),
                             jnp.asarray(pos1), cfg.text, None, rc,
                             jnp.int32(T))
    g1, pc = PM.text_forward(pp["text"], _t(emb1), _t(pos1), pcfg.text, None,
                             pc, T)
    assert pc.length == T + 1 and pc.k.data_ptr() == k_ptr  # in place
    for g, w in ((g0, w0), (g1, w1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    if quant:
        np.testing.assert_array_equal(pc.k.numpy(), np.asarray(rc.k))
        np.testing.assert_allclose(pc.k_scale.numpy(),
                                   np.asarray(rc.k_scale), rtol=1e-6)
    else:
        np.testing.assert_allclose(pc.v.numpy(), np.asarray(rc.v),
                                   atol=1e-5)


def test_kv_read_span_and_last_index_match_reference(tiny):
    """Per-row depths reading only the first 16 columns, and last_index
    logits of a tail-padded prompt."""
    cfg, pcfg, jp, pp = tiny
    B, S = 3, 32
    rng = np.random.default_rng(2)
    k0 = rng.normal(size=(2, B, S, 2, 16)).astype(np.float32)
    emb = rng.normal(size=(B, 1, 64)).astype(np.float32)
    depths = np.asarray([0, 5, 12], np.int32)
    pos = np.broadcast_to(depths[None, :, None], (3, B, 1)).copy()
    rc = RM.init_kv_cache(cfg.text, B, S, jnp.float32)._replace(
        k=jnp.asarray(k0), v=jnp.asarray(-k0))
    pc = PM.init_kv_cache(pcfg.text, B, S, torch.float32, device="cpu")
    pc.k.copy_(_t(k0))
    pc.v.copy_(_t(-k0))
    want, rc = RM.text_forward(jp["text"], jnp.asarray(emb),
                               jnp.asarray(pos), cfg.text, None, rc,
                               jnp.asarray(depths), kv_read_span=16)
    got, pc = PM.text_forward(pp["text"], _t(emb), _t(pos), pcfg.text, None,
                              pc, _t(depths), kv_read_span=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(rc.k), atol=1e-5)
    emb2 = rng.normal(size=(1, 6, 64)).astype(np.float32)
    pos2 = np.broadcast_to(np.arange(6), (3, 1, 6)).copy()
    want, _ = RM.text_forward(jp["text"], jnp.asarray(emb2),
                              jnp.asarray(pos2), cfg.text,
                              jnp.asarray(_mask(6)), last_index=3)
    got, _ = PM.text_forward(pp["text"], _t(emb2), _t(pos2), pcfg.text,
                             _t(_mask(6)), last_index=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_quantize_kv_rows_bit_for_bit():
    rows = np.random.default_rng(3).normal(size=(3, 5, 2, 16)).astype(
        np.float32) * 4
    rows[0, 0, 0] = 0.0
    wq, ws = RM.quantize_kv_rows(jnp.asarray(rows))
    gq, gs = PM.quantize_kv_rows(_t(rows))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# -- vision -----------------------------------------------------------------

@pytest.mark.parametrize("grid,uniform", [((1, 8, 8), False),
                                          ((1, 8, 8), True),
                                          ((1, 6, 10), False)])
def test_vision_forward_matches_reference(tiny, grid, uniform):
    cfg, pcfg, jp, pp = tiny
    n = grid[1] * grid[2]
    rv, pv = _vins(_patches(4, n), grid)
    assert (rv.uniform_window is not None) == (grid == (1, 8, 8))
    want = RM.vision_forward(jp["vision"], jnp.asarray(rv.patches),
                             jnp.asarray(rv.rot_pos_emb),
                             jnp.asarray(rv.window_mask),
                             jnp.asarray(rv.full_mask), cfg.vision)
    masks = (None, None) if uniform else (_t(pv.window_mask),
                                          _t(pv.full_mask))
    got = PM.vision_forward(pp["vision"], _t(pv.patches),
                            _t(pv.rot_pos_emb), *masks, pcfg.vision,
                            uniform_window=pv.uniform_window if uniform
                            else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_vision_forward_batch_equals_single_images(tiny):
    _, pcfg, _, pp = tiny
    vins = [_vins(_patches(s))[1] for s in (5, 6)]
    args = (_t(vins[0].rot_pos_emb), None, None, pcfg.vision)
    batch = PM.vision_forward(pp["vision"],
                              torch.stack([_t(v.patches) for v in vins]),
                              *args, uniform_window=16)
    for i, v in enumerate(vins):
        one = PM.vision_forward(pp["vision"], _t(v.patches), *args,
                                uniform_window=16)
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(), atol=1e-5)


# -- generation ---------------------------------------------------------------

def _gens(tiny, **kw):
    cfg, pcfg, jp, pp = tiny
    return (RGen(jp, cfg, max_len=64, dtype=jnp.float32, **kw),
            PGen(pp, pcfg, max_len=64, dtype=torch.float32, **kw))


def test_generate_from_ids_matches_reference(tiny):
    rg, pg = _gens(tiny)
    rv, pv = _vins(_patches(2))
    want = rg.generate_from_ids(IDS, rv, max_new_tokens=8)
    got = pg.generate_from_ids(IDS, pv, max_new_tokens=8)
    assert got == want and len(set(got)) > 1, (got, want)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_generate_batch_matches_reference(tiny, kv_bits):
    """Three rows through one decode loop (fp32 or the int8 KV cache)."""
    rg, pg = _gens(tiny, kv_bits=kv_bits)
    pairs = [_vins(_patches(10 + i)) for i in range(3)]
    want = rg.generate_batch_from_ids(IDS, [p[0] for p in pairs],
                                      max_new_tokens=6)
    got = pg.generate_batch_from_ids(IDS, [p[1] for p in pairs],
                                     max_new_tokens=6)
    assert got == want, (got, want)


def test_repetition_penalty_generation_matches_reference(tiny):
    scfg = dict(repetition_penalty=1.3)
    rg, pg = _gens(tiny)
    rv, pv = _vins(_patches(3))
    want = rg.generate_from_ids(IDS, rv, max_new_tokens=8,
                                sampling=RS.SamplingConfig(**scfg))
    got = pg.generate_from_ids(IDS, pv, max_new_tokens=8,
                               sampling=PS.SamplingConfig(**scfg))
    assert got == want, (got, want)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_prefill_chunk_matches_full_batch(tiny, kv_bits):
    """Sub-batch prefill merged into one cache (a ragged last chunk)
    gives the full-batch tokens."""
    _, pg = _gens(tiny, kv_bits=kv_bits)
    vins = [_vins(_patches(20 + i))[1] for i in range(5)]
    full = pg.generate_batch_from_ids(IDS, vins, max_new_tokens=5)
    chunked = pg.generate_batch_from_ids(IDS, vins, max_new_tokens=5,
                                         prefill_chunk=2)
    assert chunked == full


def test_u8_folded_path_matches_fp_path(tiny):
    """Raw uint8 patches through the normalization-folded embed (the
    extractor's default) give the host-normalized path's tokens."""
    _, pcfg, _, pp = tiny
    img = np.random.default_rng(13).integers(0, 255, (32, 32, 3),
                                             dtype=np.uint8)
    fp = PGen(pp, pcfg, max_len=64, dtype=torch.float32)
    ref = fp.generate_from_ids(IDS, PP.prepare_vision_inputs(
        img, pcfg.vision, fixed_resolution=32), max_new_tokens=6)
    folded = dict(pp)
    folded["vision"] = PC.fold_qwen_patch_normalization(pp["vision"],
                                                        pcfg.vision)
    u8 = PGen(folded, pcfg, max_len=64, dtype=torch.float32)
    u8.u8_patches = True
    vin = PP.prepare_vision_inputs(img, pcfg.vision, fixed_resolution=32,
                                   raw_uint8=True)
    assert vin.patches.dtype == np.uint8
    assert u8.generate_from_ids(IDS, vin, max_new_tokens=6) == ref


def test_padded_prompt_and_patches_match_plain(tiny):
    """Tail-padded patches (a ladder rung) and prompt (last_index
    prefill) give the unpadded tokens, as the reference's do."""
    rg, pg = _gens(tiny)
    patches = _patches(11, 60)
    rv, pv = _vins(patches, (1, 6, 10))
    ids = np.asarray([1, 2, VIS_START] + [IMG_TOK] * 15 + [3, 4, 5],
                     np.int64)
    plain = pg.generate_from_ids(ids, pv, max_new_tokens=6)
    padded = pg.generate_from_ids(ids, PP.pad_vision_inputs(pv, (72,)),
                                  max_new_tokens=6, pad_text_to=32)
    assert padded == plain == rg.generate_from_ids(ids, rv, max_new_tokens=6)


def test_generation_refusals(tiny):
    _, pg = _gens(tiny)
    pv = _vins(_patches(4))[1]
    with pytest.raises(ValueError, match="max_len"):
        pg.generate_from_ids(IDS, pv, max_new_tokens=64)
    other = PP.vision_inputs_from_patches(_patches(5, 32), (1, 8, 4),
                                          pg.cfg.vision)
    with pytest.raises(ValueError, match="shared sequence layout"):
        pg.generate_batch_from_ids(IDS, [pv, other], max_new_tokens=2)
    with pytest.raises(ValueError, match="kv_bits"):
        PGen(pg.params, pg.cfg, kv_bits=4)


# -- sampling -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(do_sample=True, top_k=12),
    dict(do_sample=True, top_p=0.85),
    dict(do_sample=True, temperature=0.7),
    dict(do_sample=True, temperature=0.7, top_k=12, top_p=0.85,
         repetition_penalty=1.3),
])
def test_warp_logits_matches_reference(kw):
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 64)).astype(np.float32) * 3
    presence = rng.random((3, 64)) < 0.2
    want = np.asarray(RS.warp_logits(jnp.asarray(logits),
                                     jnp.asarray(presence),
                                     RS.SamplingConfig(**kw)))
    got = PS.warp_logits(_t(logits), _t(presence),
                         PS.SamplingConfig(**kw)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=1e-5)


def test_sampling_is_seeded_and_inside_the_support(tiny):
    """The same seed gives the same tokens; every draw lies where the
    warped logits are finite."""
    scfg = PS.SamplingConfig(do_sample=True, temperature=0.9, top_k=20,
                             top_p=0.95, repetition_penalty=1.1)
    _, pg = _gens(tiny)
    pv = _vins(_patches(2))[1]
    a = pg.generate_from_ids(IDS, pv, max_new_tokens=6, sampling=scfg,
                             seed=3)
    assert a == pg.generate_from_ids(IDS, pv, max_new_tokens=6,
                                     sampling=scfg, seed=3)
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 64)).astype(np.float32) * 3)
    presence = torch.zeros(4, 64, dtype=torch.bool)
    warped = PS.warp_logits(logits, presence, scfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = PS.sample_token(logits, presence, gen, scfg)
        assert torch.isfinite(warped[torch.arange(4), tok]).all()


def test_generation_config_loading_matches_reference(tmp_path):
    (tmp_path / "generation_config.json").write_text(json.dumps({
        "do_sample": True, "temperature": 0.1, "top_p": 0.001,
        "repetition_penalty": 1.05, "eos_token_id": [151645, 151643]}))
    want = RS.load_generation_config(str(tmp_path), primary_eos=151645)
    got = PS.load_generation_config(str(tmp_path), primary_eos=151645)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert PS.load_generation_config(str(tmp_path / "none")) == PS.GREEDY


# -- conversion and quantization ----------------------------------------------

def _flat(tree, path=""):
    """{path: tensor} over dicts and quantized linears (fields as keys)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, PQ.QuantizedLinear):
        return {f"{path}/{f}": getattr(tree, f) for f in
                ("qweight", "scale", "bias") if getattr(tree, f) is not None}
    return {path: tree}


def _leaves_equal(port_tree, ref_tree):
    want = _flat(tree_to_torch(jax.tree.map(np.asarray, ref_tree)))
    got = _flat(port_tree)
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        b = want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


@pytest.mark.parametrize("preset", [8, 4, "mixed", "8h4"])
def test_quantize_qwen_params_matches_reference(tiny, preset):
    cfg, pcfg, jp, pp = tiny
    bits = {"mixed": RC.MIXED_DECODE_BITS, "8h4": 8}.get(preset, preset)
    head = 4 if preset in ("mixed", "8h4") else 0
    want = RC.quantize_qwen_params(jp, bits, head_bits=head,
                                   fuse_decode=True)
    pbits = PC.MIXED_DECODE_BITS if preset == "mixed" else bits
    got = PC.quantize_qwen_params(pp, pbits, head_bits=head,
                                  fuse_decode=True)
    _leaves_equal(got, want)
    layers = got["text"]["layers"]
    assert isinstance(layers["mlp"]["gateup"], PQ.QuantizedLinear)
    assert layers["mlp"]["gateup"].bits == (4 if preset in (4, "mixed")
                                            else 8)
    assert ("lm_head" in got["text"]) == bool(head)


def test_8h4_generation_matches_reference(tiny):
    """The extractor's default preset end to end: int8 fused layers and
    the int4 untied head."""
    cfg, pcfg, jp, pp = tiny
    untie = dict(tie_word_embeddings=False)
    rcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             **untie))
    prcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text,
                                                               **untie))
    rq = RC.quantize_qwen_params(jp, 8, head_bits=4, fuse_decode=True)
    pq = PC.quantize_qwen_params(pp, 8, head_bits=4, fuse_decode=True)
    rv, pv = _vins(_patches(6))
    want = RGen(rq, rcfg, max_len=64, dtype=jnp.float32).generate_from_ids(
        IDS, rv, max_new_tokens=6)
    got = PGen(pq, prcfg, max_len=64, dtype=torch.float32
               ).generate_from_ids(IDS, pv, max_new_tokens=6)
    assert got == want, (got, want)


def test_nf4_is_not_ported(tiny):
    """The NF4 preset, once refused, now quantizes every linear (the
    vision tower's too) into NF4Linear leaves; tests/test_torch_nf4.py
    holds it against the reference."""
    from vlm_clip_tpu_torch.ops.nf4 import NF4Linear

    q = PC.quantize_qwen_params(tiny[3], "nf4")
    assert isinstance(q["text"]["layers"]["mlp"]["gate"], NF4Linear)
    assert isinstance(q["vision"]["blocks"]["attn"]["qkv"], NF4Linear)
    assert "lm_head" not in q["text"]


def test_convert_qwen_vl_matches_reference(hf_model):  # noqa: F811
    from test_qwen import tiny_cfgs

    cfg = tiny_cfgs()
    sd = hf_model.state_dict()
    want = RC.convert_qwen_vl(sd, cfg)
    got = PC.convert_qwen_vl(sd, port_qwen_config(cfg), device="cpu")
    _leaves_equal(got, want)


def test_fold_patch_normalization_matches_reference(tiny):
    cfg, pcfg, jp, pp = tiny
    want = RC.fold_qwen_patch_normalization(jp["vision"], cfg.vision)
    got = PC.fold_qwen_patch_normalization(pp["vision"], pcfg.vision)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(got["patch_embed"][k].numpy(),
                                      np.asarray(want["patch_embed"][k]))


# -- host preprocessing and tokenizer -------------------------------------------

@pytest.mark.parametrize("grid", [(1, 8, 8), (1, 6, 10), (1, 32, 32)])
def test_qwen_process_arrays_match_reference(grid):
    from test_qwen import tiny_cfgs

    cfg = tiny_cfgs()
    pcfg = port_qwen_config(cfg)
    n = grid[1] * grid[2]
    patches = _patches(8, n)
    rv = RP.vision_inputs_from_patches(patches, grid, cfg.vision)
    pv = PP.vision_inputs_from_patches(patches, grid, pcfg.vision)
    for f in ("patches", "rot_pos_emb", "reverse_index"):
        np.testing.assert_array_equal(getattr(pv, f), getattr(rv, f))
    assert (pv.cu_window, pv.uniform_window) == (rv.cu_window,
                                                 rv.uniform_window)
    ids = np.asarray([1, VIS_START] + [IMG_TOK] * (n // 4) + [3, 4],
                     np.int64)
    pw, dw = PP.rope_index_single(ids, grid, pcfg)
    rw, rd = RP.rope_index_single(ids, grid, cfg)
    np.testing.assert_array_equal(pw, rw)
    assert dw == rd


def test_image_patches_ladder_and_buckets_match_reference():
    from test_qwen import tiny_cfgs

    cfg = tiny_cfgs()
    pcfg = port_qwen_config(cfg)
    img = np.random.default_rng(5).integers(0, 255, (40, 56, 3),
                                            dtype=np.uint8)
    for kw in (dict(fixed_resolution=32), dict(fixed_resolution=32,
                                                raw_uint8=True),
               dict(fixed_resolution=None, min_pixels=128,
                    max_pixels=4096)):
        pa, pg = PP.image_to_patches(img, pcfg.vision, **kw)
        ra, rg = RP.image_to_patches(img, cfg.vision, **kw)
        assert pg == rg and pa.dtype == ra.dtype
        np.testing.assert_array_equal(pa, ra)
    assert PP.default_patch_ladder(pcfg.vision) == \
        RP.default_patch_ladder(cfg.vision)
    assert PP.default_resolution_buckets(factor=8) == \
        RP.default_resolution_buckets(factor=8)
    rv = RP.prepare_vision_inputs(img, cfg.vision, fixed_resolution=None,
                                  min_pixels=128, max_pixels=4096,
                                  pad_to_ladder=(256,))
    pv = PP.prepare_vision_inputs(img, pcfg.vision, fixed_resolution=None,
                                  min_pixels=128, max_pixels=4096,
                                  pad_to_ladder=(256,))
    assert (pv.valid_len, pv.cu_window) == (rv.valid_len, rv.cu_window)
    np.testing.assert_array_equal(pv.full_mask, rv.full_mask)


def test_qwen_bpe_tokenizer_matches_reference(tmp_path):
    from vlm_clip_tpu.data.tokenizer import bytes_to_unicode
    from vlm_clip_tpu.vlm.qwen import QwenBPETokenizer as RTok
    from vlm_clip_tpu_torch.vlm.qwen import QwenBPETokenizer as PTok

    base = list(bytes_to_unicode().values())
    merges = [["Ġ", "h"], ["Ġh", "i"], ["h", "i"]]
    vocab = {t: i for i, t in enumerate(base)}
    for m in merges:
        vocab["".join(m)] = len(vocab)
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps({
        "model": {"vocab": vocab, "merges": merges},
        "added_tokens": [{"content": "<|im_start|>", "id": len(vocab)},
                         {"content": "<|im_end|>", "id": len(vocab) + 1}]}))
    rt, pt = RTok(str(path)), PTok(str(path))
    for text in ("hi hi", "<|im_start|>hi there<|im_end|>", "héllo 123!"):
        assert pt.encode(text) == rt.encode(text)
        assert pt.decode(pt.encode(text)) == rt.decode(rt.encode(text))
    ids = PP.build_prompt_ids(pt, "hi", 4, PM.qwen25vl_3b())
    np.testing.assert_array_equal(
        ids, RP.build_prompt_ids(rt, "hi", 4, RM.qwen25vl_3b()))


# -- extractors and the CLI -------------------------------------------------------

def test_extractor_refuses_without_weights(tmp_path):
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLContextExtractor

    for path in (None, str(tmp_path / "missing")):
        with pytest.raises(FileNotFoundError, match="weights not found"):
            QwenVLContextExtractor(None, None, None, weights_path=path,
                                   device="cpu")


def test_stub_and_cached_extractors_match_reference(tmp_path):
    from vlm_clip_tpu.vlm import extractor as RE
    from vlm_clip_tpu_torch.vlm import extractor as PE

    img = np.random.default_rng(0).integers(0, 255, (8, 8, 3),
                                            dtype=np.uint8)
    rs = RE.StubContextExtractor(None, None, None, fail_rate=0.3)
    ps = PE.StubContextExtractor(None, None, None, fail_rate=0.3)
    imgs = [img, img[::-1], img.T.copy()]
    assert ps.extract_contexts_batch(imgs) == rs.extract_contexts_batch(imgs)
    assert PE.VLM_PROMPT == RE.VLM_PROMPT
    key = PE.CachedContextExtractor.key_for(img)
    assert key == RE.CachedContextExtractor.key_for(img)
    (tmp_path / "contexts.json").write_text(json.dumps({key: "calm"}))
    np.savez(tmp_path / "features.npz", **{key: np.ones(4, np.float32)})
    cached = PE.CachedContextExtractor(str(tmp_path))
    assert cached.extract_context_from_image(img) == "calm"
    assert cached.encode_context_descriptions("calm").shape == (1, 4)


def test_clip_text_encoder_matches_reference():
    """The CLIP half of the extractor contract: L2-normalized [1, P]."""
    from helpers import tiny_clip_config

    from _torch_port import port_clip_config, to_torch
    from vlm_clip_tpu.core.dtypes import FP32 as RFP32
    from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
    from vlm_clip_tpu.models.clip import init_clip
    from vlm_clip_tpu.vlm import extractor as RE
    from vlm_clip_tpu_torch.core.dtypes import FP32
    from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer
    from vlm_clip_tpu_torch.vlm import extractor as PE

    cfg = tiny_clip_config()
    params = init_clip(jax.random.PRNGKey(0), cfg)
    tok_kw = dict(vocab_size=cfg.text.vocab_size)
    want = RE.StubContextExtractor(params, cfg, RHash(**tok_kw), RFP32
                                   ).encode_context_descriptions("calm")
    got = PE.StubContextExtractor(to_torch(params), port_clip_config(cfg),
                                  HashTokenizer(**tok_kw), FP32
                                  ).encode_context_descriptions("calm")
    assert got.shape == want.shape == (1, cfg.projection_dim)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert PE.StubContextExtractor(None, None, None
                                   ).encode_context_descriptions("") is None


def test_cli_bench_decode_on_cpu(monkeypatch, capsys):
    """cli/bench_decode at a tiny text config (its 3B dims patched out):
    8h4 fused and mixed with the int8 cache; the card by default."""
    from vlm_clip_tpu_torch.cli import bench_decode

    tiny = PM.QwenTextConfig(hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, num_kv_heads=2,
                             head_dim=16, vocab_size=256,
                             mrope_section=(2, 3, 3))
    monkeypatch.setattr(PM, "QwenTextConfig", lambda: tiny)
    res = bench_decode.main(["--bits", "8", "--head-bits", "4", "--fused",
                             "--batch", "3", "--new", "4", "--prompt-len",
                             "8", "--max-len", "16", "--device", "cpu"])
    assert res["tokens"].shape == (3, 4) and res["tok_per_s"] > 0
    assert "ms/token" in capsys.readouterr().out
    res = bench_decode.main(["--bits", "mixed", "--kv-bits", "8", "--new",
                             "3", "--max-len", "70", "--device", "cpu"])
    assert res["tokens"].shape == (1, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_decode.main(["--bits", "8"])


def test_qwen_presets_match_reference():
    for name in ("qwen25vl_3b", "qwen25vl_7b", "qwen25vl_72b"):
        assert dataclasses.asdict(getattr(PM, name)()) == \
            dataclasses.asdict(getattr(RM, name)())
