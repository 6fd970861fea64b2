"""Real CLIP weights into the port: convert/hf against the JAX package's
conversion and against HF's torch CLIPModel, the checkpoint directory
loader in both formats, the port's safetensors reader against the
``safetensors`` package, and cli/common's provenance and tokenizer
rules (mirroring tests/test_tokenizer.py's tests of the reference's).

Tolerances: conversions and loads exact (bit for bit); the port's towers
and logits against HF's at fp32 within 1e-5 (absolute, on features of
unit scale and logits of ~14).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from vlm_clip_tpu.convert import hf as RH
from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.cli import common
from vlm_clip_tpu_torch.convert import hf as PH
from vlm_clip_tpu_torch.convert import safetensors_io as ST
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data import tokenizer as T
from vlm_clip_tpu_torch.models import clip as C
from vlm_clip_tpu_torch.models import layers as L

from _torch_port import port_clip_config, to_torch
from helpers import make_tiny_hf_clip, rand_batch, tiny_clip_config
from test_qwen import hf_model  # noqa: F401
from test_tokenizer import _write_clip_vocab_files


@pytest.fixture(scope="module")
def hf():
    return make_tiny_hf_clip(seed=3)


@pytest.fixture(scope="module")
def pcfg():
    return port_clip_config(tiny_clip_config())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def test_convert_hf_clip_matches_reference(hf, pcfg):
    sd = hf.state_dict()
    want = to_torch(RH.convert_hf_clip(sd, tiny_clip_config()))
    _trees_equal(PH.convert_hf_clip(sd, pcfg, device="cpu"), want)


def test_towers_and_logits_match_hf(hf, pcfg):
    px, ids, mask = rand_batch(seed=4)
    params = PH.convert_hf_clip(hf.state_dict(), pcfg, device="cpu")
    t = torch.from_numpy
    with torch.no_grad():
        w_txt = hf.get_text_features(input_ids=t(ids),
                                     attention_mask=t(mask))
        w_img = hf.get_image_features(pixel_values=t(px))
        w_logits = hf(input_ids=t(ids), attention_mask=t(mask),
                      pixel_values=t(px)).logits_per_image
        txt = C.get_text_features(params, t(ids), t(mask), pcfg, FP32)
        img = C.get_image_features(params, t(px), pcfg, FP32)
        logits = params["logit_scale"].exp() * (
            L.l2_normalize(img) @ L.l2_normalize(txt).T)
    for got, want in ((txt, w_txt), (img, w_img), (logits, w_logits)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16],
                         ids=["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("safe", [True, False],
                         ids=["safetensors", "pytorch_model.bin"])
def test_load_hf_clip_equals_from_pretrained(hf, pcfg, tmp_path, safe,
                                             dtype):
    """The directory loader (no transformers) gives what
    convert_hf_clip(CLIPModel.from_pretrained(dir).state_dict()) gives,
    bit for bit, from either weights file and from weights saved in fp32,
    fp16 or bf16 (from_pretrained, given no dtype, loads all as fp32);
    with no cfg and a name that is no preset, the config comes from
    config.json."""
    import copy

    from transformers import CLIPModel

    d = str(tmp_path / "tiny")
    copy.deepcopy(hf).to(dtype).save_pretrained(d, safe_serialization=safe)
    assert os.path.isfile(os.path.join(
        d, "model.safetensors" if safe else "pytorch_model.bin"))
    want = PH.convert_hf_clip(CLIPModel.from_pretrained(d).state_dict(),
                              pcfg, device="cpu")
    assert want["logit_scale"].dtype == torch.float32
    got, cfg = PH.load_hf_clip(d, pcfg, device="cpu")
    _trees_equal(got, want)
    assert cfg is pcfg
    got2, cfg2 = PH.load_hf_clip(d, device="cpu")
    _trees_equal(got2, want)
    assert cfg2 == PH.clip_config_from_hf(hf.config)


def test_clip_config_from_hf_object_and_config_json(hf, tmp_path):
    """The same CLIPConfig from the transformers object and from the
    config.json save_pretrained writes (only values that differ from
    transformers' defaults); a config.json of defaults gives ViT-B/32."""
    from transformers import CLIPConfig as HFConfig

    hf.config.save_pretrained(str(tmp_path))
    with open(tmp_path / "config.json") as f:
        from_json = PH.clip_config_from_hf(json.load(f))
    assert from_json == PH.clip_config_from_hf(hf.config)
    assert from_json.text.eos_token_id == 2
    assert from_json.vision.image_size == 32
    default = PH.clip_config_from_hf(HFConfig())
    assert default == PH.clip_config_from_hf({})
    assert (default.vision.patch_size, default.text.vocab_size,
            default.text.eos_token_id) == (32, 49408, 49407)


def test_hub_id_resolves_to_cache_snapshot(hf, pcfg, tmp_path, monkeypatch):
    snap = tmp_path / "hub" / "models--acme--clip-tiny" / "snapshots" / "abc"
    hf.save_pretrained(str(snap))
    (tmp_path / "hub" / "models--acme--clip-tiny" / "refs").mkdir()
    (tmp_path / "hub" / "models--acme--clip-tiny" / "refs" / "main"
     ).write_text("abc")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    assert PH.resolve_checkpoint_dir("acme/clip-tiny") == str(snap)
    got, _ = PH.load_hf_clip("acme/clip-tiny", pcfg, device="cpu")
    _trees_equal(got, PH.convert_hf_clip(hf.state_dict(), pcfg, device="cpu"))
    with pytest.raises(FileNotFoundError, match="HF cache"):
        PH.resolve_checkpoint_dir("acme/absent")


def test_exported_checkpoint_round_trips(hf, pcfg, tmp_path):
    """chip_smoke.py's HF-layout writer (the inverse map and its
    safetensors writer): HF's from_pretrained reads what it writes back
    to the same tensors, and the port's loader reads it bit for bit."""
    from transformers import CLIPModel

    params = PH.convert_hf_clip(hf.state_dict(), pcfg, device="cpu")
    for fmt in ("bin", "safetensors"):
        d = str(tmp_path / fmt)
        CS.write_hf_checkpoint(d, params, pcfg, fmt)
        back = CLIPModel.from_pretrained(d).state_dict()
        _trees_equal(PH.convert_hf_clip(back, pcfg, device="cpu"), params)
        got, cfg = PH.load_hf_clip(d, device="cpu")
        _trees_equal(got, params)
        assert cfg == dataclasses.replace(pcfg, name="hf-clip")
        tok = T.get_tokenizer(os.path.join(d, "vocab.json"),
                              os.path.join(d, "merges.txt"))
        assert isinstance(tok, T.CLIPBPETokenizer)
        assert tok.encode("happy") == [tok.encoder["happy</w>"]]


# -- the safetensors reader ---------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64,
                                   np.int32, np.uint8, np.bool_])
def test_safetensors_reader_matches_package(tmp_path, dtype):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(3, 5)), "b.weight": rng.normal(size=(7,)),
              "scalar": np.asarray(rng.normal()),
              "empty": np.zeros((0, 4))}
    arrays = {k: np.asarray(v * 50, dtype) for k, v in arrays.items()}
    path = str(tmp_path / "x.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    want, got = load_file(path), ST.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_safetensors_reader_bf16_and_writer(tmp_path):
    """BF16 entries come back as torch bf16 tensors equal to
    safetensors.torch's; chip_smoke.py's writer is read back by both."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(4, 6, generator=g).to(torch.bfloat16),
               "v": torch.randn(3, generator=g),
               "h": torch.randn(2, 2, generator=g).half(),
               "s": torch.tensor(1.5, dtype=torch.bfloat16)}
    for writer in ("package", "chip_smoke"):
        path = str(tmp_path / f"{writer}.safetensors")
        if writer == "package":
            save_file(tensors, path)
        else:
            CS.write_safetensors(path, tensors)
        want, got = load_file(path), ST.load_file(path)
        for k, t in tensors.items():
            gk = got[k] if isinstance(got[k], torch.Tensor) \
                else torch.from_numpy(got[k])
            assert gk.dtype == t.dtype and gk.shape == t.shape
            assert torch.equal(gk, want[k]) and torch.equal(gk, t)


def test_load_safetensors_dir_reads_the_qwen_fixture(tmp_path,
                                                     hf_model):  # noqa: F811
    """vlm/qwen.load_safetensors_dir goes through the port's reader: the
    tiny Qwen2.5-VL of tests/test_qwen.py saved by save_pretrained loads
    equal to safetensors.numpy's read, and converts to the in-memory
    conversion's params."""
    from safetensors.numpy import load_file

    from _torch_port import port_qwen_config
    from test_qwen import tiny_cfgs
    from vlm_clip_tpu_torch.vlm import qwen_convert as PC
    from vlm_clip_tpu_torch.vlm.qwen import load_safetensors_dir

    model = hf_model
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    got = load_safetensors_dir(str(tmp_path))
    want = {}
    for f in os.listdir(tmp_path):
        if f.endswith(".safetensors"):
            want.update(load_file(str(tmp_path / f)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    cfg = port_qwen_config(tiny_cfgs())
    a = tree_leaves(PC.convert_qwen_vl(got, cfg, device="cpu"))
    b = tree_leaves(PC.convert_qwen_vl(model.state_dict(), cfg,
                                       device="cpu"))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="safetensors"):
        load_safetensors_dir(str(tmp_path / "empty"))


# -- cli/common ---------------------------------------------------------------

@pytest.fixture
def tiny_ckpt(hf, pcfg, tmp_path, monkeypatch):
    """A checkpoint dir with the tiny weights and vocab files; the preset
    lookup patched to the tiny config (a preset names the shapes)."""
    d = tmp_path / "ckpt"
    hf.save_pretrained(str(d))
    _write_clip_vocab_files(d)
    monkeypatch.setattr(common, "clip_preset", lambda name: pcfg)
    monkeypatch.setattr(T, "ASSET_DIR", str(tmp_path / "no_assets"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hub"))
    monkeypatch.setitem(common._last_load, "real_weights", False)
    monkeypatch.setitem(common._last_load, "checkpoint_dir", None)
    return str(d)


def test_load_backbone_real_weights_and_provenance(tiny_ckpt, hf, pcfg):
    params, cfg = common.load_backbone("tiny", hf_checkpoint=tiny_ckpt,
                                       require_real=True, device="cpu")
    assert cfg is pcfg and common.last_backbone_was_real()
    assert common._last_load["checkpoint_dir"] == tiny_ckpt
    _trees_equal(params, PH.convert_hf_clip(hf.state_dict(), pcfg,
                                            device="cpu"))
    tok = common.make_tokenizer(cfg)  # vocab picked up from the dir
    assert isinstance(tok, T.CLIPBPETokenizer)
    assert tok.encode("hello") == [tok.encoder["hello</w>"]]
    # an unloadable source: random init with a warning, provenance reset
    params2, _ = common.load_backbone("tiny", hf_checkpoint=tiny_ckpt + "x",
                                      device="cpu")
    assert not common.last_backbone_was_real()
    assert common._last_load["checkpoint_dir"] is None
    want = C.init_clip(torch.Generator().manual_seed(0), pcfg, device="cpu")
    for a, b in zip(tree_leaves(params2), tree_leaves(want)):
        assert torch.equal(a, b)


def test_make_tokenizer_refuses_real_weights_with_hash(tiny_ckpt, pcfg,
                                                       monkeypatch):
    monkeypatch.setitem(common._last_load, "real_weights", True)
    with pytest.raises(RuntimeError, match="hash"):
        common.make_tokenizer(pcfg)
    assert isinstance(common.make_tokenizer(pcfg, require_real=False),
                      T.HashTokenizer)
    # explicit checkpoint_dir / vocab files win over the hash fallback
    tok = common.make_tokenizer(pcfg, checkpoint_dir=tiny_ckpt)
    assert isinstance(tok, T.CLIPBPETokenizer)
    tok = common.make_tokenizer(
        pcfg, vocab_json=os.path.join(tiny_ckpt, "vocab.json"),
        merges_txt=os.path.join(tiny_ckpt, "merges.txt"))
    assert isinstance(tok, T.CLIPBPETokenizer)
    monkeypatch.setitem(common._last_load, "real_weights", False)
    assert isinstance(common.make_tokenizer(pcfg), T.HashTokenizer)


def test_load_backbone_require_real_refuses(tmp_path, monkeypatch):
    """The reference's message: no random init under require_real."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hub"))
    with pytest.raises(RuntimeError, match="refusing to fall back to "
                                           "random init"):
        common.load_backbone("vit-base-patch32",
                             hf_checkpoint=str(tmp_path),
                             require_real=True, device="cpu")
    assert not common.last_backbone_was_real()
    assert common._last_load["checkpoint_dir"] == str(tmp_path)
