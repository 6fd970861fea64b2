"""vlm_clip_tpu_torch host modules vs vlm_clip_tpu: the param bridge, the
copied config/captions/tokenizer, preprocessing and the adapter
checkpoint format. Exact equality unless a tolerance is stated."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.core import config as RC
from vlm_clip_tpu.data import captions as RCAP
from vlm_clip_tpu.data import tokenizer as RT
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu_torch.bridge import tree_to_numpy, tree_to_torch
from vlm_clip_tpu_torch.core import config as PC
from vlm_clip_tpu_torch.data import captions as PCAP
from vlm_clip_tpu_torch.data import tokenizer as PT

from helpers import tiny_clip_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tree_roundtrip_is_exact():
    cfg = tiny_clip_config()
    params = jax.tree.map(np.asarray, init_clip(jax.random.PRNGKey(0), cfg))
    tp = tree_to_torch(params)
    back = tree_to_numpy(tp)
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    # the stacked layer axis and the scalar logit scale cross as they are
    assert tuple(tp["vision"]["layers"]["attn"]["q"]["kernel"].shape) == (
        cfg.vision.num_layers, 64, 64)
    assert tp["logit_scale"].dim() == 0


def test_tree_to_torch_dtype_casts_floats_only():
    tree = {"w": np.ones((2, 3), np.float32), "ids": np.arange(4),
            "nested": [np.zeros(2, np.float32)]}
    out = tree_to_torch(tree, dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64
    assert out["nested"][0].dtype == torch.bfloat16
    # bf16 leaves come back widened to float32
    assert tree_to_numpy(out)["w"].dtype == np.float32


@pytest.mark.parametrize("name", sorted(RC._PRESETS))
def test_config_presets_match_reference(name):
    assert dataclasses.asdict(PC.clip_preset(name)) == \
        dataclasses.asdict(RC.clip_preset(name))


def test_config_constants_and_captions_match_reference():
    assert PC.EMOTIONS == RC.EMOTIONS
    assert (PC.CLIP_IMAGE_MEAN, PC.CLIP_IMAGE_STD) == \
        (RC.CLIP_IMAGE_MEAN, RC.CLIP_IMAGE_STD)
    assert dataclasses.asdict(PC.AdapterConfig()) == \
        dataclasses.asdict(RC.AdapterConfig())
    assert PCAP.get_emotion_descriptions() == RCAP.get_emotion_descriptions()
    assert PCAP.all_descriptions_flat() == RCAP.all_descriptions_flat()


TEXTS = ["a happy face", "A  person EXPRESSING anger!",
         "the image of a sad facial emotion with downturned mouth",
         "", "x " * 100]  # the last one truncates at T=77


@pytest.mark.parametrize("vocab", [1000, 49408])
def test_hash_tokenizer_ids_match_reference(vocab):
    ids_r, mask_r = RT.HashTokenizer(vocab)(TEXTS)
    ids_p, mask_p = PT.HashTokenizer(vocab)(TEXTS)
    assert ids_p.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(mask_p, mask_r)


def _write_bpe_vocab(tmp_path):
    """A small byte-level BPE vocab in HF format (vocab.json + merges)."""
    b2u = RT.bytes_to_unicode()
    toks = list(b2u.values()) + [v + "</w>" for v in b2u.values()]
    merges = [("h", "a"), ("ha", "p"), ("p", "y</w>"), ("hap", "py</w>"),
              ("f", "a"), ("fa", "c"), ("fac", "e</w>"), ("a", "n")]
    toks += ["".join(m) for m in merges]
    toks += ["<|startoftext|>", "<|endoftext|>"]
    vj, mt = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vj.write_text(json.dumps({t: i for i, t in enumerate(toks)}))
    mt.write_text("#version: 0.2\n" + "\n".join(" ".join(m)
                                                 for m in merges))
    return str(vj), str(mt)


def test_bpe_tokenizer_ids_match_reference(tmp_path):
    vj, mt = _write_bpe_vocab(tmp_path)
    texts = ["a happy face", "Happy faces, angry man's face!", "hap py"]
    ids_r, mask_r = RT.CLIPBPETokenizer.from_files(vj, mt)(texts)
    ids_p, mask_p = PT.CLIPBPETokenizer.from_files(vj, mt)(texts)
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(mask_p, mask_r)
    # and get_tokenizer picks the BPE backend from explicit files
    assert isinstance(PT.get_tokenizer(vj, mt), PT.CLIPBPETokenizer)


def test_normalize_batch_matches_reference():
    from vlm_clip_tpu.data.preprocess import normalize_batch_tpu
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch

    u8 = np.random.default_rng(0).integers(0, 255, (2, 8, 8, 3), np.uint8)
    want = np.asarray(normalize_batch_tpu(jnp.asarray(u8)))
    got = normalize_batch(torch.from_numpy(u8)).numpy()
    assert got.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_adapter_checkpoints_cross_packages(tmp_path):
    """An M adapter file written by either package loads in the other
    with identical values (the reference .pt layout)."""
    from vlm_clip_tpu.models.model_m import init_m_adapters
    from vlm_clip_tpu.train import checkpoint as RCK
    from vlm_clip_tpu_torch.train import checkpoint as PCK

    cfg = tiny_clip_config()
    acfg = RC.AdapterConfig(text_adapter_size=8, vision_adapter_size=8,
                            shared_adapter_layers=2, shared_num_heads=4)
    pacfg = PC.AdapterConfig(**dataclasses.asdict(acfg))
    ref = init_m_adapters(jax.random.PRNGKey(3), cfg, acfg)
    path = str(tmp_path / "ref.pt")
    RCK.save_adapter_weights(path, ref)
    port = PCK.load_adapter_weights(path, pacfg, device="cpu")
    a = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref))[0]
    b = jax.tree_util.tree_flatten_with_path(tree_to_numpy(port))[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=str(path_))

    path2 = str(tmp_path / "port.pt")
    PCK.save_adapter_weights(path2, port)
    again = RCK.load_adapter_weights(path2, acfg)
    for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    # strict validation: a file holding a kind that is not enabled
    with pytest.raises(ValueError, match="not enabled"):
        PCK.load_adapter_weights(path, dataclasses.replace(
            pacfg, use_text_adapter=False), device="cpu")


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys; import vlm_clip_tpu_torch.cli.serve, "
            "vlm_clip_tpu_torch.cli.train_m, "
            "vlm_clip_tpu_torch.models.model_m, "
            "vlm_clip_tpu_torch.ops.fused_adapter, "
            "vlm_clip_tpu_torch.ops.contrastive, "
            "vlm_clip_tpu_torch.ops.image, vlm_clip_tpu_torch.data.rafdb, "
            "vlm_clip_tpu_torch.train.steps, "
            "vlm_clip_tpu_torch.train.trainer_m, "
            "vlm_clip_tpu_torch.utils.logging, "
            "vlm_clip_tpu_torch.train.checkpoint, vlm_clip_tpu_torch.bridge; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'vlm_clip_tpu' or "
            "m.startswith('vlm_clip_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
