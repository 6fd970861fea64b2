"""The port's small entry points on the CPU: cli/smoke (hermetic towers
and a checkpoint directory), cli/install_tokenizer (against the
reference's on the same vocab files), cli/example on a tiny RAF-DB tree
(the preset swapped for the tiny config, as the other CLI tests do) and
utils/misc against the reference's. cli/smoke and cli/example are held
against the reference's entry points from the same weights (the
reference's random init bridged into the port's).

Tolerances: both smokes run pipeline M in bf16 (the BF16 policy), so
their features are held by relative error in norm within 2e-2, as
tests/test_torch_model_m.py holds bf16 towers (each framework rounds to
bf16's 8 bits at its own places); the loss, at B=1 the log-softmax of
one logit, within 1e-5. The examples train in bf16 too: their epoch
losses within 2e-2 relative.
"""

import numpy as np
import pytest
import torch

import jax

from vlm_clip_tpu.core.config import AdapterConfig as RAdapterConfig
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu.utils import misc as RM
from vlm_clip_tpu_torch.cli import common
from vlm_clip_tpu_torch.data import tokenizer as T
from vlm_clip_tpu_torch.utils import misc as M

from _torch_port import port_adapter_config, port_clip_config, to_torch
from helpers import make_tiny_hf_clip, tiny_clip_config
from test_tokenizer import _write_clip_vocab_files
from test_torch_trainer_m import _write_tree


def test_smoke_hermetic_and_from_a_checkpoint_dir(tmp_path, monkeypatch,
                                                  capsys):
    from vlm_clip_tpu_torch.cli import smoke

    out = smoke.main(["--device", "cpu"])
    assert np.isfinite(out["loss"])
    assert out["text_features"] == out["image_features"] == (1, 64)
    assert "smoke test OK" in capsys.readouterr().out
    # --clip-model-name: a backbone through cli/common.load_backbone
    d = tmp_path / "ckpt"
    make_tiny_hf_clip(seed=1).save_pretrained(str(d))
    monkeypatch.setattr(common, "clip_preset",
                        lambda name: port_clip_config(tiny_clip_config()))
    out = smoke.main(["--clip-model-name", str(d), "--device", "cpu"])
    assert common.last_backbone_was_real() and np.isfinite(out["loss"])
    assert out["image_features"] == (1, 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        smoke.main([])


BF16_REL = 2e-2


def _record(monkeypatch, module, name, keep=lambda out: out):
    """Wrap ``module.name`` so each call's (args, kwargs, keep(out)) is
    appended to the returned list."""
    calls, fn = [], getattr(module, name)

    def wrap(*a, **k):
        out = fn(*a, **k)
        calls.append((a, k, keep(out)))
        return out

    monkeypatch.setattr(module, name, wrap)
    return calls


def _rel(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_smoke_matches_reference(monkeypatch):
    """The hermetic smoke of both packages from the same towers and
    adapters (the reference's PRNGKey(0)/(1) init, bridged): the same
    config, adapter config, caption ids and pixels, and features and
    loss within the bf16 tolerances."""
    from vlm_clip_tpu.cli import smoke as RS
    from vlm_clip_tpu.models import model_m as RMM
    from vlm_clip_tpu_torch.cli import smoke
    from vlm_clip_tpu_torch.models import clip as PCL
    from vlm_clip_tpu_torch.models import model_m as PMM

    ref = _record(monkeypatch, RMM, "m_forward")
    RS.main([])
    (ra, _, rout), = ref
    r_clip, r_ad, r_ids, r_mask, r_px, r_cfg, r_acfg = ra[:7]
    monkeypatch.setattr(PCL, "init_clip",
                        lambda gen, cfg, device: to_torch(r_clip))
    monkeypatch.setattr(PMM, "init_m_adapters",
                        lambda gen, cfg, acfg, device: to_torch(r_ad))
    port = _record(monkeypatch, PMM, "m_forward")
    smoke.main(["--device", "cpu"])
    (pa, _, pout), = port
    _, _, p_ids, p_mask, p_px, p_cfg, p_acfg = pa[:7]
    assert p_cfg == port_clip_config(r_cfg)
    assert p_acfg == port_adapter_config(r_acfg)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(r_mask))
    np.testing.assert_array_equal(p_px.numpy(), np.asarray(r_px))
    for k in ("text_features", "image_features"):
        assert _rel(getattr(pout, k), getattr(rout, k)) <= BF16_REL, k
    assert abs(float(pout.loss) - float(rout.loss)) <= 1e-5


def test_example_matches_reference(tmp_path, monkeypatch, capsys):
    """cli/example of both packages on the same tiny tree from the same
    state: the reference's random tiny backbone (PRNGKey(0)) bridged into
    the port's load_backbone, the reference trainer's initial adapters
    into the port's trainer. The same parameter counts, and the first
    epoch's train and val losses within 2e-2 relative (bf16)."""
    from vlm_clip_tpu.cli import common as RCM
    from vlm_clip_tpu.cli import example as RE
    from vlm_clip_tpu.train import trainer_m as RT
    from vlm_clip_tpu_torch.cli import example
    from vlm_clip_tpu_torch.models import clip as PCL
    from vlm_clip_tpu_torch.train import trainer_m as PT

    tree = _write_tree(tmp_path / "rafdb")
    cfg = tiny_clip_config()
    monkeypatch.setattr(RCM, "clip_preset", lambda name: cfg)
    monkeypatch.setattr(common, "clip_preset",
                        lambda name: port_clip_config(cfg))
    r_init = _record(monkeypatch, RT, "init_train_state",
                     lambda st: jax.tree.map(np.array, st.adapter_params))
    r_train = _record(monkeypatch, RT.CLIPAdapterTrainer, "train")
    RE.main(["--data-root", tree, "--num-epochs", "1", "--batch-size", "4",
             "--output-dir", str(tmp_path / "ref")])
    ref_text = capsys.readouterr().out
    assert not RCM.last_backbone_was_real()

    clip = to_torch(init_clip(jax.random.PRNGKey(0), cfg))
    monkeypatch.setattr(PCL, "init_clip", lambda gen, c, device: clip)
    (_, _, r_adapters), = r_init
    orig = PT.init_train_state
    monkeypatch.setattr(
        PT, "init_train_state",
        lambda *a, **k: orig(*a, adapter_params=to_torch(r_adapters), **k))
    res = example.main(["--data-root", tree, "--num-epochs", "1",
                        "--batch-size", "4", "--output-dir",
                        str(tmp_path / "port"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert not common.last_backbone_was_real()

    def counts(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("Frozen CLIP", "Trainable adapter"))]

    assert counts(text) == counts(ref_text) and len(counts(text)) == 2
    (_, _, want), = r_train
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(res["history"][0][key], want[0][key],
                                   rtol=BF16_REL, err_msg=key)


def test_install_tokenizer_matches_reference(tmp_path, monkeypatch, capsys):
    from vlm_clip_tpu.cli import install_tokenizer as RI
    from vlm_clip_tpu_torch.cli import install_tokenizer as PI

    _, _, vocab = _write_clip_vocab_files(tmp_path)
    printed = []
    for mod, dest in ((PI, tmp_path / "port"), (RI, tmp_path / "ref")):
        assert mod.main([str(tmp_path), "--asset-dir", str(dest)]) == 0
        printed.append(capsys.readouterr().out.split("vocab=")[1])
        assert (dest / "vocab.json").read_text() == \
            (tmp_path / "vocab.json").read_text()
    assert printed[0] == printed[1]  # vocab size and sample ids
    # into the package's asset dir: get_tokenizer() is then exact
    monkeypatch.setattr(T, "ASSET_DIR", str(tmp_path / "assets"))
    assert PI.main([str(tmp_path / "vocab.json")]) == 0
    tok = T.get_tokenizer()
    assert isinstance(tok, T.CLIPBPETokenizer)
    assert tok.encode("hello") == [vocab["hello</w>"]]


def test_example_on_a_tiny_tree(tmp_path, monkeypatch, capsys):
    from vlm_clip_tpu_torch.cli import example

    tree = _write_tree(tmp_path / "rafdb")
    monkeypatch.setattr(common, "clip_preset",
                        lambda name: port_clip_config(tiny_clip_config()))
    out_dir = tmp_path / "ckpt"
    res = example.main(["--data-root", tree, "--num-epochs", "1",
                        "--batch-size", "4", "--output-dir", str(out_dir),
                        "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Frozen CLIP parameters" in text
    assert "reloaded best checkpoint" in text
    assert np.isfinite(res["history"][0]["train_loss"])
    assert res["sims"].shape[0] == 4 and np.isfinite(res["sims"]).all()
    assert np.all(np.abs(res["sims"]) <= 1 + 1e-5)  # cosines
    assert (out_dir / "best_adapter").exists()
    ref = init_clip(jax.random.PRNGKey(0), tiny_clip_config())
    assert res["n_clip"] == RM.count_trainable_params(ref)


def test_misc_matches_reference(monkeypatch):
    ref = init_clip(jax.random.PRNGKey(0), tiny_clip_config())
    assert M.count_trainable_params(to_torch(ref)) == \
        RM.count_trainable_params(ref)
    assert M.count_trainable_params({"a": [torch.zeros(2, 3)],
                                     "b": torch.zeros(4)}) == 10
    assert M.get_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="get_device\\('cpu'\\)"):
        M.get_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert M.get_device() == torch.device("cuda:0")
