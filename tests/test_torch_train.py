"""The port's training step and QAT (``hdrtv_tpu_torch/train.py``,
``quant/qat.py``) on the CPU, against the JAX package's on the same numpy
frames, at 32 × 64 on ``weights/hr_fp32.npz``.

Held here: ``qat_loss`` within a relative LOSS_RTOL, with and without a
teacher, with empty and non-empty highlight and dark masks; one step's loss
(LOSS_RTOL) and gradients (each leaf within GRAD_TOL of its largest
magnitude) against ``jax.value_and_grad`` of the same loss, plain and under
the STE fake-quant; three Adam steps' losses within ADAM_RTOL (Adam's first
step is lr·sign(g), which two sums of a near-zero gradient can set apart:
the losses, not the parameters, are compared); ``run_qat`` gives the same
layer mix as JAX's with at most RUN_QAT_FLIPS int8 codes apart; the train
state survives a save and load and resumes to the same next loss; autograd
through the natural program leaves its forward values as they are.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
f32 = np.float32
H, W = 32, 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest gradient magnitude
VJP_MEDIAN, VJP_TOL = 1e-5, 1e-3  # the whole model's VJP at 128 × 256: its median and worst leaf
ADAM_RTOL = 1e-4
LR = 2e-6
# run_qat, 3 steps, asymmetric on every default layer (585,460 codes): the
# codes the two runs' latent weights may round apart (0 seen; about 1e-5 of
# them allowed), and its activation scales' relative bound (4.4e-7 seen).
RUN_QAT_FLIPS = 6
RUN_QAT_X_RTOL = 1e-5
FQ_LAYERS = ["LE.conv_first", "LE.HR_conv1", "LE.recon_trunk3.0.conv1", "AGCM.cond_scale_first"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fp32():
    from hdrtv_tpu_torch.models.import_npz import load_npz

    return load_npz(WEIGHTS)


def frames(n=2, seed=21):
    rng = np.random.RandomState(seed)
    return [rng.rand(H, W, 3).astype(f32) for _ in range(n)]


def jax_inputs(frame):
    from hdrtv_tpu.ops.resize import downsample_quarter_aa

    img = jnp.asarray(frame[None], jnp.float32)
    return img, downsample_quarter_aa(img)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("teacher", [False, True], ids=["gt", "teacher"])
@pytest.mark.parametrize("masks", ["empty", "both"])
def test_qat_loss_matches_jax(teacher, masks):
    from hdrtv_tpu.train import qat_loss as jax_loss
    from hdrtv_tpu_torch.train import qat_loss

    rng = np.random.RandomState(1)
    out, gt, t = (rng.uniform(0.3, 0.6, (1, 16, 24, 3)).astype(f32) for _ in range(3))
    if masks == "both":  # dark rows at the top, bright ones at the bottom of both references
        for ref in (gt, t):
            ref[:, :4] *= 0.2
            ref[:, -4:] += 0.4
    want = jax_loss(jnp.asarray(out), jnp.asarray(gt), jnp.asarray(t) if teacher else None)
    got = qat_loss(torch.from_numpy(out), torch.from_numpy(gt), torch.from_numpy(t) if teacher else None)
    assert rel(got, want) <= LOSS_RTOL
    ref = t if teacher else gt
    assert (ref.max(-1) > 0.75).any() == (masks == "both") == (ref.max(-1) < 0.15).any()


def _jax_value_and_grad(params, frame, fq_layers):
    """The JAX step's loss and gradients: with fake-quant layers, distilled
    from the float teacher (run_qat's targets); without, against the frame
    itself (a float model distilled from itself has an L1 at its kink)."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig, model_apply
    from hdrtv_tpu.quant.qat import make_weight_fake_quant
    from hdrtv_tpu.train import qat_loss

    fq = make_weight_fake_quant(fq_layers)
    img, cond = jax_inputs(frame)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    t_out = model_apply(jp, img, cond, ModelConfig()) if fq_layers else None
    gt = img if t_out is None else t_out

    def loss_fn(p):
        return qat_loss(model_apply(fq(p), img, cond, ModelConfig()), gt, t_out)

    return jax.value_and_grad(loss_fn)(jp)


def _torch_step(params, frame, fq_layers, lr=LR):
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.qat import make_weight_fake_quant
    from hdrtv_tpu_torch.train import init_state, make_train_step

    img, cond = frame_inputs(frame, "cpu")
    t_out = None
    if fq_layers:
        with torch.no_grad():
            t_out = model_apply(natural_params_to_torch(params, "cpu"), img, cond, ModelConfig())
    state = init_state(params, lr=lr, device="cpu")
    step = make_train_step(ModelConfig(), fake_quant=make_weight_fake_quant(fq_layers))
    state, loss = step(state, img, cond, img if t_out is None else t_out, t_out)
    return state, loss


@pytest.mark.parametrize("fq", [False, True], ids=["to_frame", "fake_quant"])
def test_train_step_matches_value_and_grad(fp32, fq):
    layers = FQ_LAYERS if fq else []
    frame = frames(1)[0]
    want_loss, want_grads = _jax_value_and_grad(fp32, frame, layers)
    state, loss = _torch_step(fp32, frame, layers)
    assert rel(loss, want_loss) <= LOSS_RTOL
    reached = 0
    for k, g in want_grads.items():
        g = np.asarray(g)
        t = state.params[k].grad
        scale = float(np.abs(g).max())
        if t is None:  # a leaf the loss does not reach: zero in JAX
            assert scale == 0.0, k
            continue
        reached += 1
        assert float(np.abs(t.numpy() - g).max()) <= GRAD_TOL * max(scale, 1e-30), k
    assert reached > 100


@pytest.mark.parametrize("fq", [False, True], ids=["float", "fake_quant"])
def test_classifier_gradients_match_jax(fp32, fq):
    """The AGCM classifier alone on the condition image of a 128 × 256
    frame (32 × 64: its last InstanceNorm sees 8 pixels, so its leaves have
    gradients; at the 32 × 64 frames above they are zero): a seeded VJP of
    its vector, each of its 20 leaves within GRAD_TOL of its largest
    gradient against jax.grad of the same one."""
    from hdrtv_tpu.models.agcm import classifier_apply as jax_classifier
    from hdrtv_tpu.quant.qat import make_weight_fake_quant as jax_fq
    from hdrtv_tpu_torch.models.agcm import classifier_apply
    from hdrtv_tpu_torch.models.hdrtvnet import natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.int8 import quantizable_layers
    from hdrtv_tpu_torch.quant.qat import make_weight_fake_quant

    pre = "AGCM.classifier."
    frame = np.random.RandomState(4).rand(128, 256, 3).astype(f32)
    names = [k for k in fp32 if k.startswith(pre)]
    layers = [l for l in quantizable_layers(fp32) if l.startswith(pre)] if fq else []
    cot = np.random.RandomState(6).randn(1, 6).astype(f32)  # the classifier's vector: 6 values

    _, jcond = jax_inputs(frame)
    jp = {k: jnp.asarray(fp32[k]) for k in names}
    jfq = jax_fq(layers)
    want = jax.grad(lambda p: jnp.sum(jax_classifier(jfq(p), pre, "color_condition", jcond) * cot))(jp)

    _, cond = frame_inputs(frame, "cpu")
    q = {k: v.requires_grad_(True) for k, v in natural_params_to_torch({k: fp32[k] for k in names}, "cpu").items()}
    out = classifier_apply(make_weight_fake_quant(layers)(q), pre, "color_condition", cond)
    out.backward(torch.from_numpy(cot))
    assert len(names) == 20
    for k in names:
        g = np.asarray(want[k])
        scale = float(np.abs(g).max())
        assert scale > 0.0, k
        assert float(np.abs(q[k].grad.numpy() - g).max()) <= GRAD_TOL * scale, k


def test_seeded_vjp_matches_jax_at_128x256(fp32):
    """The whole model's gradients where the AGCM classifier's are not zero:
    a seeded VJP through the fake-quantized model (the default QAT layers)
    at 128 × 256, every leaf against jax.grad of the same one. Two fp32
    programs summing in other orders, with leaky ReLUs whose input lies
    within them: the median leaf within VJP_MEDIAN, the worst within VJP_TOL
    (6.7e-4 seen, LE.recon_trunk5.0.sft2.SFT_scale_conv0.bias; the
    classifier's leaves 3.5e-5 here, 1.4e-4 on a uniform noise frame).
    chip_smoke.py phase 12 (d) holds the card against the CPU to the same
    bounds on the same frame."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JCfg, model_apply as jax_apply
    from hdrtv_tpu.quant.qat import make_weight_fake_quant as jax_fq
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.int8 import DEFAULT_EXCLUDE_SUFFIXES, quantizable_layers
    from hdrtv_tpu_torch.quant.qat import make_weight_fake_quant
    from hdrtv_tpu_torch.tools.qat_probe import natural_u8_frames

    layers = [l for l in quantizable_layers(fp32) if not l.endswith(DEFAULT_EXCLUDE_SUFFIXES)]
    frame = natural_u8_frames(1, (128, 256))[0]  # phase 12 (d)'s frame and cotangent
    cot = np.random.RandomState(12).randn(1, 128, 256, 3).astype(f32)

    img, cond = jax_inputs(frame)
    floats = {k: jnp.asarray(v) for k, v in fp32.items() if np.issubdtype(np.asarray(v).dtype, np.floating)}
    rest = {k: jnp.asarray(v) for k, v in fp32.items() if k not in floats}
    jfq = jax_fq(layers)
    want = jax.grad(lambda p: jnp.sum(jax_apply(jfq({**p, **rest}), img, cond, JCfg()) * cot))(floats)

    ti, tc = frame_inputs(frame, "cpu")
    q = {k: v.requires_grad_(v.is_floating_point()) for k, v in natural_params_to_torch(fp32, "cpu").items()}
    model_apply(make_weight_fake_quant(layers)(q), ti, tc, ModelConfig()).backward(torch.from_numpy(cot))
    rel_of = {}
    for k, g in want.items():
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        if q[k].grad is None:  # a leaf the model does not read: zero in JAX
            assert scale == 0.0, k
            continue
        assert scale > 0.0, k
        rel_of[k] = float(np.abs(q[k].grad.numpy() - g).max()) / scale
    rels = sorted(rel_of.values())
    assert len(rels) > 250 and sum(".classifier." in k for k in rel_of) == 20
    assert rels[len(rels) // 2] <= VJP_MEDIAN and rels[-1] <= VJP_TOL, max(rel_of.items(), key=lambda kv: kv[1])


def test_three_adam_steps_match_jax(fp32):
    import optax

    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JCfg, model_apply as jax_apply
    from hdrtv_tpu.quant.qat import make_weight_fake_quant as jax_fq
    from hdrtv_tpu.train import init_state as jax_init, make_train_step as jax_step
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.qat import make_weight_fake_quant
    from hdrtv_tpu_torch.train import init_state, make_train_step

    lr = 1e-4  # large enough that the steps move the loss
    fs = frames(3, seed=5)
    opt = optax.adam(lr)
    jtrain = jax_step(JCfg(), opt, fake_quant=jax_fq(FQ_LAYERS))
    jstate = jax_init({k: jnp.asarray(v) for k, v in fp32.items()}, opt)
    teacher_j = {k: jnp.asarray(v) for k, v in fp32.items()}
    state = init_state(fp32, lr=lr, device="cpu")
    train = make_train_step(ModelConfig(), fake_quant=make_weight_fake_quant(FQ_LAYERS))
    teacher = natural_params_to_torch(fp32, "cpu")
    got, want = [], []
    for f in fs:
        img, cond = jax_inputs(f)
        t = jax_apply(teacher_j, img, cond, JCfg())
        jstate, jl = jtrain(jstate, img, cond, t, t)
        ti, tc = frame_inputs(f, "cpu")
        with torch.no_grad():
            tt = model_apply(teacher, ti, tc, ModelConfig())
        state, tl = train(state, ti, tc, tt, tt)
        got.append(float(tl))
        want.append(float(jl))
    assert state.step == 3
    assert all(rel(g, w) <= ADAM_RTOL for g, w in zip(got, want)), (got, want)
    assert got[0] != got[2]


def test_run_qat_matches_jax(fp32):
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JCfg
    from hdrtv_tpu.quant.qat import run_qat as jax_run_qat
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.quant.int8 import DEFAULT_EXCLUDE_SUFFIXES, quantizable_layers, quantized_layer_summary
    from hdrtv_tpu_torch.quant.qat import run_qat

    layers = [l for l in quantizable_layers(fp32) if not l.endswith(DEFAULT_EXCLUDE_SUFFIXES)]
    fs = frames(2, seed=3)
    got, losses = run_qat(fp32, ModelConfig(), layers, fs, steps=3, log=None, device="cpu")
    want, jlosses = jax_run_qat(fp32, JCfg(), layers, fs, steps=3, log=None)
    assert sorted(got) == sorted(want)
    assert set(quantized_layer_summary(got).values()) == {"w8a8-asym", "fp"}
    assert sum(v == "w8a8-asym" for v in quantized_layer_summary(got).values()) == len(layers)
    assert all(rel(g, w) <= ADAM_RTOL for g, w in zip(losses, jlosses)), (losses, jlosses)
    flips = sum(int((got[k] != want[k]).sum()) for k in got if k.endswith(".weight_int8"))
    assert flips <= RUN_QAT_FLIPS, flips
    for k in got:
        if k.endswith((".x_scale", ".x_zero")):
            assert abs(float(got[k]) - float(want[k])) <= RUN_QAT_X_RTOL * max(abs(float(want[k])), 1e-6), k


def test_train_state_round_trip(fp32, tmp_path):
    """Save after one step, load, step again: the same loss and parameters
    as the run that was never interrupted."""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.qat import make_weight_fake_quant
    from hdrtv_tpu_torch.train import init_state, load_train_state, make_train_step, save_train_state

    f0, f1 = frames(2, seed=8)
    train = make_train_step(ModelConfig(), fake_quant=make_weight_fake_quant(FQ_LAYERS))
    teacher = natural_params_to_torch(fp32, "cpu")

    def step(state, f):
        img, cond = frame_inputs(f, "cpu")
        with torch.no_grad():
            t = model_apply(teacher, img, cond, ModelConfig())
        return train(state, img, cond, t, t)

    state = init_state(fp32, lr=1e-4, device="cpu")
    state, _ = step(state, f0)
    path = save_train_state(str(tmp_path / "state"), state)
    assert path.endswith(".pt")
    resumed = load_train_state(path, device="cpu")
    assert resumed.step == 1
    state, l_orig = step(state, f1)
    resumed, l_res = step(resumed, f1)
    assert float(l_orig) == float(l_res)
    for k, v in state.params.items():
        assert torch.equal(v.detach(), resumed.params[k].detach()), k


def test_autograd_leaves_the_forward_values(fp32):
    """The natural program, written for inference, under autograd: the same
    output bit for bit, and a backward that reaches the first conv."""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs

    img, cond = frame_inputs(frames(1)[0], "cpu")
    p = natural_params_to_torch(fp32, "cpu")
    with torch.inference_mode():
        plain = model_apply(p, img, cond, ModelConfig())
    q = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in p.items()}
    out = model_apply(q, img, cond, ModelConfig())
    assert torch.equal(out.detach(), plain)
    out.abs().mean().backward()
    assert q["AGCM.conv_first.weight"].grad is not None and q["LE.conv_first.weight"].grad.abs().sum() > 0
