"""The ``clip_m`` family: what a traffic kind of pipeline M's adapter
training (the program's ``train/steps.make_m_train_step``) builds on.

Set-up makes the towers', the adapters' and the batches' numbers on the
device from the seed, builds one train state and step, and drives that
same state through the traffic's first ``check_steps`` steps (rows that
all differ), snapshotting what the comparison needs: each step's loss,
the first gradient as Adam holds it after step 1, and the adapters after
the last of them. The kind's window then runs the same step from there.
After the window the program's state is freed and the plain reference
follows the first steps from the same numbers (:func:`compare`).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from hb import traffic as TR
from hb.common import Checks

# ---------------------------------------------------------------------------
# numbers made from the seed (the benchmark's own; the reference remakes
# them), in the program's tree layout
# ---------------------------------------------------------------------------


def _ln(L, H, dev):
    lead = (L,) if L else ()
    return {"scale": torch.ones(*lead, H, device=dev),
            "bias": torch.zeros(*lead, H, device=dev)}


def _lin(g, lead, din, dout, dev, bias=True, uniform=False):
    if uniform:
        w = (torch.rand(*lead, din, dout, generator=g, device=dev) * 2 - 1) \
            * din ** -0.5
    else:
        w = torch.randn(*lead, din, dout, generator=g, device=dev) \
            * din ** -0.5
    p = {"kernel": w}
    if bias:
        p["bias"] = torch.zeros(*lead, dout, device=dev)
    return p


def _stack(g, L, H, inter, dev):
    lead = (L,)
    return {"attn": {k: _lin(g, lead, H, H, dev) for k in
                     ("q", "k", "v", "out")},
            "mlp": {"fc1": _lin(g, lead, H, inter, dev),
                    "fc2": _lin(g, lead, inter, H, dev)},
            "ln1": _ln(L, H, dev), "ln2": _ln(L, H, dev)}


def make_clip(seed: int, cfg: dict, dev) -> dict:
    """CLIP tower params (fp32) from the seed."""
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    v, t = cfg["vision_config"], cfg["text_config"]
    Hv, Ht, P = v["hidden_size"], t["hidden_size"], cfg["projection_dim"]
    ps = v["patch_size"]
    n = (v["image_size"] // ps) ** 2 + 1
    return {
        "vision": {
            "class_embedding": torch.randn(Hv, generator=g, device=dev)
            * Hv ** -0.5,
            "patch_embedding": {"kernel": torch.randn(
                ps, ps, 3, Hv, generator=g, device=dev)
                * (3 * ps * ps) ** -0.5},
            "position_embedding": torch.randn(n, Hv, generator=g,
                                              device=dev) * Hv ** -0.5,
            "pre_layernorm": _ln(0, Hv, dev),
            "post_layernorm": _ln(0, Hv, dev),
            "layers": _stack(g, v["num_hidden_layers"], Hv,
                             v["intermediate_size"], dev)},
        "text": {
            "token_embedding": torch.randn(t["vocab_size"], Ht, generator=g,
                                           device=dev) * 0.02,
            "position_embedding": torch.randn(
                t["max_position_embeddings"], Ht, generator=g,
                device=dev) * 0.01,
            "final_layernorm": _ln(0, Ht, dev),
            "layers": _stack(g, t["num_hidden_layers"], Ht,
                             t["intermediate_size"], dev)},
        "visual_projection": {"kernel": torch.randn(
            Hv, P, generator=g, device=dev) * Hv ** -0.5},
        "text_projection": {"kernel": torch.randn(
            Ht, P, generator=g, device=dev) * Ht ** -0.5},
        "logit_scale": torch.tensor(float(cfg["logit_scale_init_value"]),
                                    device=dev),
    }


def make_adapters(seed: int, cfg: dict, dev) -> dict:
    """Pipeline M's adapters (fp32) from the seed: kernels uniform in
    +-1/sqrt(fan_in), biases 0, LayerNorms at 1 and 0."""
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63) ^ 0x5A)
    v, t, a = cfg["vision_config"], cfg["text_config"], cfg["adapters"]
    Ht, Hv = t["hidden_size"], v["hidden_size"]

    def seq(H, K):
        return {"down": _lin(g, (), H, K, dev, uniform=True),
                "up": _lin(g, (), K, H, dev, uniform=True),
                "ln": _ln(0, H, dev)}

    L = (a["shared_adapter_layers"],)
    return {
        "text_adapter": seq(Ht, a["text_adapter_size"]),
        "vision_adapter": seq(Hv, a["vision_adapter_size"]),
        "shared_adapters": {
            "text_proj": _lin(g, L, Ht, Ht, dev, uniform=True),
            "image_proj": _lin(g, L, Hv, Ht, dev, uniform=True),
            "attn": {k: _lin(g, L, Ht, Ht, dev, uniform=True)
                     for k in ("q", "k", "v", "out")},
            "norm1": _ln(L[0], Ht, dev), "norm2": _ln(L[0], Ht, dev),
            "norm3": _ln(L[0], Ht, dev),
            "mlp": {"fc1": _lin(g, L, Ht, 4 * Ht, dev, uniform=True),
                    "fc2": _lin(g, L, 4 * Ht, Ht, dev, uniform=True)}},
    }


def make_batches(seed: int, cfg: dict, tr: dict, dev) -> List[dict]:
    """The ring: ``ring`` batches of ``batch`` pairs, every row distinct:
    bf16 pixels N(0, 1) and captions of the traffic's lengths."""
    v, t = cfg["vision_config"], cfg["text_config"]
    B, R = tr["batch"], tr["ring"]
    lo, hi = tr["caption_len"]
    ids, mask = TR.captions(B * R, lo, hi, tr["pad_to"], t["vocab_size"],
                            t["bos_token_id"], t["eos_token_id"],
                            TR.rng(seed, 1))
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63) ^ 0xA5)
    S = v["image_size"]
    px = torch.randn(B * R, 3, S, S, generator=g, device=dev).to(
        torch.bfloat16)
    ids = torch.from_numpy(ids).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    return [{"input_ids": ids[i * B:(i + 1) * B],
             "attention_mask": mask[i * B:(i + 1) * B],
             "pixel_values": px[i * B:(i + 1) * B]} for i in range(R)]


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def _program(cfg: dict):
    """(CLIPConfig, AdapterConfig, optimizer recipe, policy) of the
    program for this configuration."""
    from vlm_clip_tpu_torch.core import dtypes
    from vlm_clip_tpu_torch.core.config import (AdapterConfig, CLIPConfig,
                                                TextConfig, VisionConfig)
    from vlm_clip_tpu_torch.train import optim

    v, t, a = cfg["vision_config"], cfg["text_config"], cfg["adapters"]
    ccfg = CLIPConfig(
        vision=VisionConfig(
            hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"],
            num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], image_size=v["image_size"],
            patch_size=v["patch_size"], layer_norm_eps=v["layer_norm_eps"],
            hidden_act=v["hidden_act"]),
        text=TextConfig(
            hidden_size=t["hidden_size"],
            intermediate_size=t["intermediate_size"],
            num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"], vocab_size=t["vocab_size"],
            max_positions=t["max_position_embeddings"],
            layer_norm_eps=t["layer_norm_eps"], hidden_act=t["hidden_act"],
            eos_token_id=t["eos_token_id"]),
        projection_dim=cfg["projection_dim"],
        logit_scale_init=cfg["logit_scale_init_value"])
    acfg = AdapterConfig(text_adapter_size=a["text_adapter_size"],
                         vision_adapter_size=a["vision_adapter_size"],
                         shared_adapter_layers=a["shared_adapter_layers"],
                         shared_num_heads=a["shared_num_heads"])
    if cfg["optimizer"]["name"] != "adam":
        raise ValueError(f"unknown optimizer {cfg['optimizer']['name']!r}")
    tx = optim.adam(cfg["optimizer"]["learning_rate"])
    return ccfg, acfg, tx, getattr(dtypes, cfg["policy"])


def _with_fault(step, fault: Optional[str]):
    """The timed path broken on purpose, for the harness's own tests:
    ``frozen`` puts the adapters back after every step (a step that
    leaves its state unchanged); ``half_batch`` trains on the first half
    of every batch."""
    if fault is None:
        return step
    if fault == "half_batch":
        def half(state, batch):
            n = batch["input_ids"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    if fault == "frozen":
        from vlm_clip_tpu_torch.bridge import tree_leaves

        def frozen(state, batch):
            keep = [p.detach().clone()
                    for p in tree_leaves(state.adapter_params)]
            out = step(state, batch)
            with torch.no_grad():
                for p, k in zip(tree_leaves(state.adapter_params), keep):
                    p.copy_(k)
            return out
        return frozen
    raise ValueError(f"unknown fault {fault!r}")


def _leaf_paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaf_paths(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def setup(cfg: dict, tr: dict, seed: int, dev, fault=None):
    """One train state and step from the seed, driven through the
    traffic's first ``check_steps`` steps: (state, step, ring, adapters
    at the start, losses, first gradient norms, change norms)."""
    from vlm_clip_tpu_torch.train.steps import (init_train_state,
                                                make_m_train_step)

    ccfg, acfg, tx, policy = _program(cfg)
    clip = make_clip(seed, cfg, dev)
    adapters = make_adapters(seed, cfg, dev)
    ring = make_batches(seed, cfg, tr, dev)
    a0 = {k: t.detach().clone() for k, t in _leaf_paths(adapters)}
    state = init_train_state(None, ccfg, acfg, tx, clip_params=clip,
                             freeze_clip=cfg["freeze_towers"], device=dev,
                             adapter_params=adapters)
    step = _with_fault(make_m_train_step(
        ccfg, acfg, tx, policy, freeze_clip=cfg["freeze_towers"]), fault)
    losses, first_grad = [], {}
    for i in range(tr["check_steps"]):
        state, m = step(state, ring[i % len(ring)])
        losses.append(float(m.loss))
        if i == 0:
            opt = state.opt_state
            b1 = opt.param_groups[0]["betas"][0]
            for path, p in _leaf_paths(state.adapter_params):
                first_grad[path] = float(
                    opt.state[p]["exp_avg"].float().norm()) / (1 - b1)
    after = {path: float((p.detach().float() - a0[path]).norm())
             for path, p in _leaf_paths(state.adapter_params)}
    return state, step, ring, a0, losses, first_grad, after


def reference_readings(seed, cfg, ring, a0, losses, first_grad, after, dev,
                       prec):
    """The three numbers compared, against the fp32 reference: the worst
    step's loss gap (relative), the worst leaf's first-gradient norm gap
    and the worst leaf's change gap after the steps, each over the
    larger of the reference's norm of that leaf and the median leaf's.
    ``prec`` != fp32 puts the reference at that precision in the
    program's place (the control). Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and
    are left out of the change."""
    import statistics

    from reference import clip_m as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clip = make_clip(seed, cfg, dev)
    tree = _rebuild(make_adapters(seed, cfg, dev), a0)
    ref = R.train(clip, tree, ring, cfg, "fp32")
    if prec != "fp32":
        alt = R.train(clip, tree, ring, cfg, prec)
        losses, first_grad, after = (alt["losses"], alt["grad_norms"],
                                     alt["change_norms"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                      ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(first_grad[k] - g_ref[k]) / max(g_ref[k], g_med)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in moved)
    change_gap = max(abs(after[k] - c_ref[k]) / max(c_ref[k], c_med)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "left_out": sorted(set(g_ref) - set(moved))}


def _rebuild(tree, flat, prefix=""):
    return {k: (_rebuild(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"]) for k, v in tree.items()}


def compare(seed, cfg, ring, a0, losses, first_grad, after, limits, dev,
            prec) -> Checks:
    r = reference_readings(seed, cfg, ring, a0, losses, first_grad, after,
                           dev, prec)
    checks = Checks()
    for name in ("loss_gap", "grad_gap", "change_gap"):
        checks.add(name, r[name], limits[name])
    return checks
