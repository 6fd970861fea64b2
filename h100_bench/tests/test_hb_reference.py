"""The plain references agree with the program's CPU path at tiny sizes:
pipeline M's step with the program in fp32, and Qwen2.5-VL's served
tokens against the reference's logits."""

import time

import torch

from hb import qwen_vl
from reference import qwen_vl as R

from conftest import kind



def test_clip_m_reference_matches_fp32_program(tiny_clip):
    cfg, tr = tiny_clip
    cfg = dict(cfg, policy="FP32")
    out = kind("train_ring").run({}, cfg, tr, 2 ** 31 + 5, 0.2, False,
                                 torch.device("cpu"), time.perf_counter(),
                                 {"loss_gap": 1e-4, "grad_gap": 1e-3,
                                  "change_gap": 1e-3})
    assert out["correct"], out["checks"].items


def test_qwen_reference_matches_program_tokens(tiny_qwen):
    cfg, tr = tiny_qwen
    out = kind("static_batches").run({}, cfg, tr, 2 ** 31 + 7, 0.5, False,
                                     torch.device("cpu"), time.perf_counter(),
                                     {"token_gap": 0.02})
    assert out["correct"], out["checks"].items


def test_prompt_ids_match_the_programs(tiny_qwen):
    from vlm_clip_tpu_torch.vlm.qwen_process import build_prompt_ids

    cfg, tr = tiny_qwen
    tok = qwen_vl.Words(cfg["special_tokens"])
    ours = qwen_vl.prompt_ids(tok, tr["prompt"], 64, cfg)
    theirs = build_prompt_ids(tok, tr["prompt"], 64,
                              qwen_vl.program_config(cfg))
    assert ours == list(theirs)
    pos = R.rope_index(ours, (1, 16, 16), cfg)
    st = ours.index(cfg["vision_start_token_id"]) + 1
    assert pos.shape == (3, len(ours))
    assert pos[:, st + 63].tolist() == [st, st + 7, st + 7]
    assert pos[0, st + 64] == st + 8


def test_quantization_by_hand():
    w = torch.tensor([[1.0, -0.5], [-2.0, 0.3]])
    q8 = R.quantize(w, 8)
    assert torch.allclose(q8[:, 0], torch.tensor([1.0, -2.0]), atol=2 / 127)
    q4 = R.quantize(w, 4)
    s = 0.5 / 7
    assert torch.allclose(q4[:, 1], torch.tensor([-7 * s, 4 * s]))
