"""The card's routes take the nf = 32 base model's widths alone; a checkpoint
of another nf is refused at load on a CUDA device, where its first frame
would otherwise fail inside a kernel wrapper (trunk3's C = 32 check, the
Hopper tiles' natural widths), and runs on the CPU as before.

The nf = 16 checkpoint is written here from the shipped one: every LE layer
outside the condition network cut to half its 32- and 128-channel widths
(the SFT condition's 16 channels and the CondNet's 64 kept). It is a
checkpoint of the right shapes, not a trained one. These tests touch no CUDA
device: the refusal comes before any parameter is moved.
"""

import json
import os

import numpy as np
import pytest
import torch

from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
from hdrtv_tpu_torch.models.import_npz import load_npz, save_npz
from hdrtv_tpu_torch.runtime.processor import CARD_NF, HDRTVNetTorch, check_card_widths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")


@pytest.fixture(scope="module")
def nf16_checkpoint(tmp_path_factory):
    out = {}
    for k, v in load_npz(WEIGHTS).items():
        if k.startswith("LE.") and not k.startswith(("LE.cond_first", "LE.CondNet")):
            v = v[tuple(slice(0, d // 2) if d in (32, 128) else slice(None) for d in v.shape)]
        out[k] = v
    with open(os.path.join(ROOT, "weights", "hr_fp32.json")) as f:
        arch = {**json.load(f), "nf": 16}
    path = str(tmp_path_factory.mktemp("nf16") / "hr_nf16.npz")
    save_npz(path, out, {"architecture": arch})
    return path


@pytest.mark.parametrize("nf,device,turbo,refused", [
    (16, "cuda", True, True), (64, "cuda:0", True, True),
    (CARD_NF, "cuda", True, False), (16, "cuda", False, False), (16, "cpu", True, False),
])
def test_check_card_widths(nf, device, turbo, refused):
    cfg = ModelConfig(nf=nf)
    if refused:
        with pytest.raises(ValueError, match=f"nf = {CARD_NF} base model's widths.*nf = {nf}"):
            check_card_widths(cfg, device, turbo=turbo)
    else:
        check_card_widths(cfg, torch.device(device), turbo=turbo)


def test_nf16_checkpoint_is_refused_on_the_card_at_load(nf16_checkpoint):
    for precision in ("fp16", "fp32"):
        with pytest.raises(ValueError, match="this checkpoint has nf = 16"):
            HDRTVNetTorch(nf16_checkpoint, precision=precision, device="cuda")


def test_nf16_checkpoint_runs_on_the_cpu(nf16_checkpoint):
    proc = HDRTVNetTorch(nf16_checkpoint, precision="fp32", device="cpu")
    assert proc.cfg.nf == 16 and proc.turbo
    assert proc.params["LE.recon_trunk3.0.conv1.weight"].shape[-1] == 16  # trunk3 runs natural widths
    frame = (np.random.RandomState(16).rand(64, 96, 3) * 255).astype(np.uint8)
    out = proc.process_rgb48(frame)
    assert out.shape == (64, 96, 3) and out.dtype == np.uint16 and out.max() > 0
