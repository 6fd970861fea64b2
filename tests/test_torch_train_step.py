"""The port's pipeline-M train step and what it is built from, against the
JAX package on the same params and batch (tiny config, CPU): the K4
contrastive head's plain versions, the optimizer recipes, the on-device
resize, and 1-3 steps of make_m_train_step.

Tolerances, with their reasons:
- schedule values 1e-5 relative: optax evaluates in fp32 (its cosine
  near the end of the decay, where the value is small, keeps about five
  digits), the port in Python floats;
- optimizer updates 1e-6: the same fp32 formulas, other rounding order;
- K4 1e-5: fp32 through one BxB product and two softmaxes;
- resize 1e-3 on 0-255 pixel values (about 4e-6 relative): fp32
  products in another summation order;
- the step, FP32 policy: loss and grad norm 1e-5 relative, gradients
  1e-4 of the largest gradient (fp32 through 2+2 tower layers and the
  adapters; XLA and PyTorch sum in other orders), params after Adam
  2*lr (Adam's update is about lr*sign(g) where |g| is near its eps, so
  a gradient that differs in its last bits can move a param by up to
  lr; 2*lr allows that on two steps).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.core.config import AdapterConfig as RAdapterConfig
from vlm_clip_tpu.core.config import TrainConfig as RTrainConfig
from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.models import clip as RC
from vlm_clip_tpu.models import model_m as RM
from vlm_clip_tpu.ops.contrastive import contrastive_loss_fused as r_k4
from vlm_clip_tpu.ops.image import resize_normalize_tpu
from vlm_clip_tpu.train import optim as RO
from vlm_clip_tpu.train import steps as RS
from vlm_clip_tpu_torch.bridge import tree_map, tree_to_numpy
from vlm_clip_tpu_torch.core.config import TrainConfig
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.ops import contrastive as K4
from vlm_clip_tpu_torch.ops.image import resize_normalize
from vlm_clip_tpu_torch.train import optim as O
from vlm_clip_tpu_torch.train import steps as S

from _torch_port import port_adapter_config, port_clip_config, to_torch
from helpers import rand_batch, tiny_clip_config


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, tree))[0]


def _assert_trees(got, want, atol, what):
    a, b = _flat(got), _flat(want)
    assert [p for p, _ in a] == [p for p, _ in b], what
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(
            x, y, atol=atol, rtol=0,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# K4: contrastive head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 48])
def test_contrastive_plain_matches_pallas(B):
    rng = np.random.default_rng(B)
    txt, img = (rng.normal(size=(B, 64)).astype(np.float32)
                for _ in range(2))
    ls = np.float32(2.0)
    want = float(r_k4(jnp.asarray(txt), jnp.asarray(img), jnp.asarray(ls)))
    wgrads = jax.grad(r_k4, argnums=(0, 1, 2))(
        jnp.asarray(txt), jnp.asarray(img), jnp.asarray(ls))
    t, m, s = (torch.tensor(a) for a in (txt, img, ls))
    np.testing.assert_allclose(float(K4.contrastive_loss_torch(t, m, s)),
                               want, atol=1e-5)
    # the analytic plain backward, and autograd of the plain forward
    got = K4.contrastive_loss_bwd_torch(t, m, s, torch.tensor(1.0))
    leaves = [a.clone().requires_grad_(True) for a in (t, m, s)]
    loss = K4.contrastive_loss_fused(*leaves)  # CPU: the plain version
    loss.backward()
    for name, g, a, w in zip(("txt", "img", "logit_scale"), got, leaves,
                             wgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   atol=1e-5, err_msg=name)


def test_contrastive_refuses_bad_shapes():
    with pytest.raises(ValueError, match="B, D"):
        K4.contrastive_loss_fused(torch.zeros(3, 4), torch.zeros(2, 4),
                                  torch.tensor(0.0))
    with pytest.raises(ValueError, match="B, D"):
        K4.contrastive_loss_fused(torch.zeros(0, 4), torch.zeros(0, 4),
                                  torch.tensor(0.0))


# ---------------------------------------------------------------------------
# optimizer recipes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,warmup", [("linear", 5), ("linear", 0),
                                             ("cosine", 5), ("cosine", 0),
                                             ("constant", 0)])
def test_schedule_matches_optax(schedule, warmup):
    total = 20
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, schedule=schedule)
    want = RO.make_schedule(RTrainConfig(**kw), total)
    got = O.make_schedule(TrainConfig(**kw), total)
    for step in sorted({0, max(warmup - 1, 0), warmup, total // 2,
                        total - 1, total + 3}):
        w = float(want(step)) if callable(want) else float(want)
        np.testing.assert_allclose(got(step), w, rtol=1e-5, atol=1e-12,
                                   err_msg=f"step {step}")
    # a warmed-up run's first update (count 0) has learning rate 0
    assert got(0) == (0.0 if warmup else 3e-4)


@pytest.mark.parametrize("weight_decay,max_norm", [(0.01, 1.0), (0.0, 1.0),
                                                   (0.01, 100.0),
                                                   (0.0, None)])
def test_clip_and_adamw_match_optax(weight_decay, max_norm):
    """Three updates (warmup 1, so the first at lr 0) on the same params
    and gradients: one with norm above max_norm, then below it."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.1, 0.01)]
    kw = dict(learning_rate=1e-2, weight_decay=weight_decay,
              warmup_steps=1, max_grad_norm=max_norm, schedule="linear")
    tx = RO.make_optimizer(RTrainConfig(**kw), 10)
    want = jax.tree.map(jnp.asarray, params)
    state = tx.init(want)
    opt = O.make_optimizer(TrainConfig(**kw), 10)
    leaves = [torch.tensor(params[k]).requires_grad_(True) for k in "ab"]
    topt = opt.init(leaves)
    for count, g in enumerate(grads):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, want)
        want = optax.apply_updates(want, upd)
        for p, k in zip(leaves, "ab"):
            p.grad = torch.tensor(g[k])
        gl = [p.grad for p in leaves]
        norm = O.global_norm(gl)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            jax.tree.map(jnp.asarray, g))), rtol=1e-6)
        opt.update(topt, count, gl, norm)
        for p, k in zip(leaves, "ab"):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(want[k]), atol=1e-6,
                                       err_msg=f"update {count} {k}")


# ---------------------------------------------------------------------------
# on-device resize (the uint8 branch of _pixels_on_device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(40, 50), (20, 24)])
def test_resize_normalize_matches_reference(hw):
    u8 = np.random.default_rng(1).integers(0, 255, (2, *hw, 3), np.uint8)
    want = np.asarray(resize_normalize_tpu(jnp.asarray(u8), 32))
    got = resize_normalize(torch.from_numpy(u8), 32).numpy()
    assert got.shape == (2, 3, 32, 32)
    # 1e-3 of a 0-255 pixel, through the normalization's 1/(255*std)
    np.testing.assert_allclose(got, want, atol=1e-3 / (255 * 0.26))
    via_step = S._pixels_on_device(torch.from_numpy(u8), FP32, 32)
    torch.testing.assert_close(via_step, torch.from_numpy(got))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

LR = 1e-3


def _step_pair(freeze_clip, fused_loss=False):
    cfg = tiny_clip_config()
    acfg = RAdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                          shared_adapter_layers=1, shared_num_heads=4)
    params = RC.init_clip(jax.random.PRNGKey(0), cfg)
    ap = RM.init_m_adapters(jax.random.PRNGKey(1), cfg, acfg)
    kw = dict(learning_rate=LR, weight_decay=0.01, warmup_steps=1,
              max_grad_norm=1.0, schedule="linear")
    tx = RO.make_optimizer(RTrainConfig(**kw), 4)
    trainable = ap if freeze_clip else {"adapters": ap, "clip": params}
    jstate = RS.TrainState(ap, params, tx.init(trainable),
                           jnp.zeros((), jnp.int32))
    jstep = RS.make_m_train_step(cfg, acfg, tx, RFP32,
                                 freeze_clip=freeze_clip)
    pcfg, pacfg = port_clip_config(cfg), port_adapter_config(acfg)
    ptx = O.make_optimizer(TrainConfig(**kw), 4)
    pstate = S.init_train_state(None, pcfg, pacfg, ptx,
                                clip_params=to_torch(params),
                                freeze_clip=freeze_clip,
                                adapter_params=to_torch(ap), device="cpu")
    pstep = S.make_m_train_step(pcfg, pacfg, ptx, FP32,
                                freeze_clip=freeze_clip,
                                fused_loss=fused_loss)

    def ref_grads(state, batch):
        """The reference step's clipped gradients at ``state``."""
        def loss(tr):
            a, c = (tr, state.clip_params) if freeze_clip \
                else (tr["adapters"], tr["clip"])
            return RM.m_forward(c, a, batch["input_ids"],
                                batch["attention_mask"],
                                batch["pixel_values"], cfg, acfg,
                                RFP32).loss
        tr = state.adapter_params if freeze_clip else \
            {"adapters": state.adapter_params, "clip": state.clip_params}
        g = jax.grad(loss)(tr)
        norm = optax.global_norm(g)
        return jax.tree.map(lambda x: jnp.where(norm < 1.0, x,
                                                x / norm * 1.0), g)

    return jstate, jstep, pstate, pstep, ref_grads


def _port_tree(state, freeze_clip, what):
    get = (lambda p: p.grad) if what == "grad" else (lambda p: p.detach())
    tree = {"adapters": tree_map(get, state.adapter_params),
            "clip": tree_map(get, state.clip_params)}
    return tree_to_numpy(tree["adapters"] if freeze_clip else tree)


@pytest.mark.parametrize("freeze_clip,fused_loss", [(True, False),
                                                    (False, False),
                                                    (True, True)])
def test_train_step_matches_jax(freeze_clip, fused_loss):
    px, ids, mask = rand_batch()
    jbatch = {"input_ids": jnp.asarray(ids),
              "attention_mask": jnp.asarray(mask),
              "pixel_values": jnp.asarray(px)}
    pbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in
              (("input_ids", ids), ("attention_mask", mask),
               ("pixel_values", px))}
    jstate, jstep, pstate, pstep, ref_grads = _step_pair(freeze_clip,
                                                         fused_loss)
    for i in range(2):
        g_want = ref_grads(jstate, jbatch)
        jstate, jm = jstep(jstate, jbatch)
        pstate, pm = pstep(pstate, pbatch)
        np.testing.assert_allclose(float(pm.loss), float(jm.loss),
                                   rtol=1e-5, err_msg=f"loss {i}")
        np.testing.assert_allclose(float(pm.grad_norm),
                                   float(jm.grad_norm), rtol=1e-5,
                                   err_msg=f"grad norm {i}")
        g_got = _port_tree(pstate, freeze_clip, "grad")
        scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(
            jax.tree.map(np.asarray, g_want)))
        _assert_trees(g_got, g_want, 1e-4 * scale, f"grad {i}")
        want_params = jstate.adapter_params if freeze_clip else \
            {"adapters": jstate.adapter_params, "clip": jstate.clip_params}
        _assert_trees(_port_tree(pstate, freeze_clip, "param"),
                      want_params, 2 * LR, f"params {i}")
    assert pstate.step == 2


def test_eval_step_and_zero1_refusal():
    cfg = tiny_clip_config()
    acfg = RAdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                          shared_adapter_layers=1, shared_num_heads=4)
    params = RC.init_clip(jax.random.PRNGKey(0), cfg)
    ap = RM.init_m_adapters(jax.random.PRNGKey(1), cfg, acfg)
    px, ids, mask = rand_batch()
    want = RS.make_m_eval_step(cfg, acfg, RFP32)(
        ap, params, {"input_ids": jnp.asarray(ids),
                     "attention_mask": jnp.asarray(mask),
                     "pixel_values": jnp.asarray(px)})
    pcfg, pacfg = port_clip_config(cfg), port_adapter_config(acfg)
    got = S.make_m_eval_step(pcfg, pacfg, FP32)(
        to_torch(ap), to_torch(params),
        {"input_ids": torch.from_numpy(ids),
         "attention_mask": torch.from_numpy(mask),
         "pixel_values": torch.from_numpy(px)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # ZeRO-1 shards over a process group's ranks: none is up here
    with pytest.raises(ValueError, match="process group"):
        S.make_m_train_step(pcfg, pacfg, O.adam(1e-3), FP32,
                            zero1_mesh=object())
    assert dataclasses.is_dataclass(O.adam(1e-3))
