"""The port's KAZE (`ops/kaze.py`, `ops/doh.detect_levels`) against the
benchmark's plain float64 reference (`pano_bench/kaze_reference.py`), on
seeded images of blobs, straight edges and noise (2 x 96 x 128), and the
reference's own invariants. The reference imports nothing of the port, so
the two agree only where both follow the scheme the `kaze800`
configuration states.

Tolerances, each against float64 (readings of seeds 1-3, float32 port):
- contrast k: rtol 1e-4 (read <= 1.3e-6 here, 5.0e-6 on a 320x240 view
  of the benchmark's smooth ring: the gradient of a smooth image is a
  difference of close float32 values, and float32 may move the percentile
  by a rank);
- the FED step sizes: the same counts, each step within 1e-12 relative
  (host floats, summed to T in another way);
- the levels: FED's long explicit steps (tau up to 16.7 against the 0.25
  stability limit, cycles of up to 18 steps) amplify float32 rounding,
  more the longer a level's cycles. Read: levels 0-3 <= 6.0e-6, 4-5 <=
  2.3e-4, 6 <= 2.3e-2, 7 <= 0.37 (of a range of 0.4-0.64; the float64
  levels shrink in range level by level, so level 7's error is the
  float32 scheme's, not the reference's). Held: 0-3 within 1e-4, 4-5
  within 2e-3, 6 within 0.1, 7 within 1.0, the bounds the JAX parity test
  (`test_torch_detectors.py`) holds the same levels to, tightened where
  float64 allows; every level's mean to level 0's within 1e-5 (FED
  conserves the mean under Neumann boundaries);
- the responses sigma^4 det H on the same level: within 3e-5 of the
  level's largest (read <= 6.0e-6: float32 blurs up to sigma = 18.1);
- the keypoints: >= 90 % of the reference's at the same level and within
  0.5 px (read 92.6-100 %: a maximum on level 5 or 6 is decided against
  level 6 or 7, where the float32 levels are furthest off).

Negative controls, which must fail the comparison: the port's steps with L
rounded to bfloat16 between steps (levels 1-3 off by 9e-3 to 0.4), and
SURF's Gaussian levels in place of the diffusion (2.6e-2 to 0.16).

The FED step (`kernels/kaze.py`): its plain version equals a numpy float32
step written out in the order both versions document (bit for bit), the
wrapper's checks raise, a CPU tensor takes the plain version, and the scale
space reaches the step through `ops/kaze._diffusion_step`; on a card the
kernel equals the plain version bit for bit, one step and a whole group's
scale space, and launches once a step.
"""

import math

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.kernels import kaze as kaze_kernels
from autopanostitch_tpu_torch.ops import doh, kaze
from autopanostitch_tpu_torch.utils import trace
from pano_bench import kaze_reference as ref

SIG = ref.sigmas()
LEVEL_ATOL = (1e-4, 1e-4, 1e-4, 1e-4, 2e-3, 2e-3, 0.1, 1.0)
K_RTOL = 1e-4
RESP_REL = 3e-5
KEYPOINT_SHARE = 0.90


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(seed: int, G: int = 2, H: int = 96, W: int = 128) -> torch.Tensor:
    """(G, H, W) float64 in [0, 1]: 40 Gaussian blobs of radius 2-12 px,
    4 straight steps and a little noise an image."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64), indexing="ij")
    out = []
    for _ in range(G):
        img = torch.zeros(H, W, dtype=torch.float64)
        for _ in range(40):
            cy, cx = (torch.rand(2, generator=g, dtype=torch.float64)
                      * torch.tensor([H, W], dtype=torch.float64))
            r = 2 + 10 * torch.rand(1, generator=g, dtype=torch.float64)
            a = torch.rand(1, generator=g, dtype=torch.float64) - 0.5
            img += a * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        for _ in range(4):
            th = torch.rand(1, generator=g, dtype=torch.float64) * math.pi
            c = torch.rand(1, generator=g, dtype=torch.float64) * (H + W) / 2
            img += 0.15 * ((xx * torch.cos(th) + yy * torch.sin(th)) > c).double()
        img += 0.02 * torch.randn(H, W, generator=g, dtype=torch.float64)
        out.append((img - img.min()) / (img.max() - img.min()))
    return torch.stack(out)


def level_errors(levels: torch.Tensor, reference: torch.Tensor) -> list:
    return (levels.double() - reference).abs().amax((0, 2, 3)).tolist()


def levels_agree(levels: torch.Tensor, reference: torch.Tensor) -> bool:
    means = (levels.double().mean((2, 3)) - reference.mean((2, 3))).abs().max()
    return (all(e <= tol for e, tol in zip(level_errors(levels, reference), LEVEL_ATOL))
            and float(means) <= 1e-5)


def keypoint_share(port_kp, ref_kp) -> float:
    """The share of the reference's keypoints that the port has at the same
    level, within 0.5 px (both lie on pixels), over the group."""
    vals, si, y, x = port_kp
    found = total = 0
    for i in range(vals.shape[0]):
        port = {(int(l), int(a), int(b)) for v, l, a, b in zip(vals[i], si[i], y[i], x[i])
                if v > 0}
        for v, l, a, b in zip(ref_kp.response[i], ref_kp.level[i], ref_kp.y[i], ref_kp.x[i]):
            if v > 0:
                total += 1
                found += (int(l), int(a), int(b)) in port
    return found / max(total, 1)


@pytest.fixture(scope="module", params=[1, 2])
def case(request):
    img = images(request.param)
    return img, ref.contrast_k(img), ref.scale_space(img, SIG)


def test_sigma_ladder_is_the_ports():
    assert ref.sigmas() == pytest.approx(doh.doh_sigmas(DetectorConfig()), rel=1e-15)


def test_contrast_k(case):
    img, k_ref, _ = case
    k = kaze.contrast_k(img.float())
    torch.testing.assert_close(k.double(), k_ref, rtol=K_RTOL, atol=0)


@pytest.mark.parametrize("T", [0.0, 0.3, 1.28, 5.12, 20.48, 40.96, 81.92, 163.84])
def test_fed_steps(T):
    """Grewenig's step sizes in the port's cycles, and 11 cycles of 137
    steps over the ladder."""
    port, want = kaze.fed_cycles(T), ref.cycles(T)
    assert [len(c) for c in port] == [len(c) for c in want]
    for a, b in zip(port, want):
        assert a == pytest.approx(b, rel=1e-12)
        assert sum(b) == pytest.approx(T / len(want), rel=1e-12)
    cycles = [c for a, b in zip(SIG[:-1], SIG[1:]) for c in ref.cycles(0.5 * (b * b - a * a))]
    assert (len(cycles), sum(map(len, cycles))) == (11, 137)


def test_levels(case):
    img, _, L_ref = case
    L = kaze.nonlinear_scale_space(img.float(), SIG)
    assert torch.isfinite(L).all()
    errs = level_errors(L, L_ref)
    assert levels_agree(L, L_ref), errs


def test_responses(case):
    """The port's sigma-sized DoH of the reference's levels."""
    _, _, L_ref = case
    for i, s in enumerate(SIG):
        want = ref.response(L_ref[:, i], s)
        got = kaze.hessian_response_scharr(L_ref[:, i].float(), s).double()
        assert float((got - want).abs().max()) <= RESP_REL * float(want.abs().max()), i


def test_keypoints(case):
    img, _, L_ref = case
    L = kaze.nonlinear_scale_space(img.float(), SIG)
    port = doh.detect_levels(L, SIG, 256, kaze.hessian_response_scharr)
    want = ref.detect(L_ref, SIG, 256)
    assert int((want.response > 0).sum()) >= 40
    assert keypoint_share(port, want) >= KEYPOINT_SHARE


def test_bf16_steps_fail(case, monkeypatch):
    """L rounded to bfloat16 between the port's steps: the levels fail."""
    img, _, L_ref = case
    step = kaze._diffusion_step
    monkeypatch.setattr(kaze, "_diffusion_step",
                        lambda L, g, tau: step(L, g, tau).bfloat16().float())
    L = kaze.nonlinear_scale_space(img.float(), SIG)
    assert not levels_agree(L, L_ref)
    errs = level_errors(L, L_ref)
    assert sum(e > tol for e, tol in zip(errs, LEVEL_ATOL)) >= 4, errs


def test_gaussian_levels_fail(case):
    """SURF's Gaussian ladder in place of the diffusion: the levels fail."""
    img, _, L_ref = case
    L = torch.stack([kaze.gaussian_blur(img.float(), s) for s in SIG], 1)
    assert not levels_agree(L, L_ref)
    errs = level_errors(L, L_ref)
    assert all(e > tol for e, tol in zip(errs[1:4], LEVEL_ATOL[1:4])), errs


def test_reference_keeps_a_constant_image():
    img = torch.full((1, 40, 56), 0.37, dtype=torch.float64)
    L = ref.scale_space(img, SIG, k=torch.tensor([0.05], dtype=torch.float64))
    assert float((L - 0.37).abs().max()) <= 1e-12


def test_reference_keeps_the_mean():
    """Each FED step conserves the mean under Neumann boundaries, so every
    level has level 0's (the base blur's) mean."""
    L = ref.scale_space(images(3, G=1), SIG)
    drift = (L.mean((2, 3)) - L[:, :1].mean((2, 3))).abs().max()
    assert float(drift) <= 1e-12


@pytest.mark.cuda
def test_timed_group_on_a_card(monkeypatch):
    """On a card (`python -m pytest --noconftest -m cuda -s
    tests/test_torch_kaze_reference.py`): the first group of 8 views of a
    `kaze800.ring38` folder as the timed path (`api.stitch`) hands it to the
    scale space, its contrast k, levels and keypoints against the reference
    computed in float64 on the card, to the tolerances above; the readings
    are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    from autopanostitch_tpu_torch import api
    from pano_bench import scenes, spec

    bench = spec.load_benchmark()
    wl = spec.workload(bench, "kaze800.ring38")
    cfg = spec.stitch_config(spec.config_file(bench, wl["config"]))
    folder = scenes.make(spec.traffic(wl["traffic"]), 2**33 + 17, 0, torch.device("cuda"))
    seen = {}
    space, detect = kaze.nonlinear_scale_space, doh.detect_levels

    def space_seen(img, sigmas, *args, **kwargs):
        out = space(img, sigmas, *args, **kwargs)
        seen.setdefault("group", (img.clone(), kwargs.get("k"), out.clone()))
        return out

    def detect_seen(*args, **kwargs):
        out = detect(*args, **kwargs)
        seen.setdefault("keypoints", tuple(t.clone() for t in out))
        return out

    monkeypatch.setattr(kaze, "nonlinear_scale_space", space_seen)
    monkeypatch.setattr(doh, "detect_levels", detect_seen)
    api.stitch(folder.iset, cfg, seed=folder.stitch_seed, device="cuda")
    img, k, L = seen["group"]
    assert img.shape == (8, 600, 800) and L.shape == (8, 8, 600, 800)
    k_ref = ref.contrast_k(img.double())
    L_ref = ref.scale_space(img.double(), SIG)
    kp_ref = ref.detect(L_ref, SIG, cfg.detector.max_keypoints)
    k_rel = float(((k.double() - k_ref) / k_ref).abs().max())
    errs = level_errors(L, L_ref)
    means = float((L.double().mean((2, 3)) - L_ref.mean((2, 3))).abs().max())
    resp = [float((kaze.hessian_response_scharr(L_ref[:, i].float(), s).double()
                   - ref.response(L_ref[:, i], s)).abs().max()
                  / ref.response(L_ref[:, i], s).abs().max()) for i, s in enumerate(SIG)]
    share = keypoint_share(seen["keypoints"], kp_ref)
    print("kaze card comparison: " + json.dumps({
        "device": torch.cuda.get_device_name(0), "k_rel": k_rel, "level_err": errs,
        "level_range": (L_ref.amax((0, 2, 3)) - L_ref.amin((0, 2, 3))).tolist(),
        "mean_err": means, "response_rel": resp, "keypoint_share": share,
        "keypoints_ref": int((kp_ref.response > 0).sum()),
        "keypoints_port": int((seen["keypoints"][0] > 0).sum())}))
    assert k_rel <= K_RTOL
    assert all(e <= tol for e, tol in zip(errs, LEVEL_ATOL)) and means <= 1e-5, errs
    assert max(resp) <= RESP_REL
    assert share >= KEYPOINT_SHARE


# ------------------------------------------------------------------ the FED step

LAST_CYCLE = kaze.fed_cycles(0.5 * (SIG[-1] ** 2 - SIG[-2] ** 2))[0]  # the longest steps


def step_inputs(shape, seed: int, device="cpu"):
    """Levels in [0, 1) and a conductivity in (0, 1], float32."""
    gen = torch.Generator().manual_seed(seed)
    L = torch.rand(shape, generator=gen)
    g = 1.0 - torch.rand(shape, generator=gen)
    return L.to(device), g.to(device)


def numpy_step(L, g, tau: float):
    """The step in the documented order: neighbours E, W, S, N with clamped
    indices, each (0.5 * (g + g_nb)) * (L_nb - L) added to a flux from 0,
    then L + tau * flux, every operation rounded in float32."""
    L, g = np.asarray(L, np.float32), np.asarray(g, np.float32)
    _, H, W = L.shape
    ys, xs = np.arange(H), np.arange(W)
    nbs = ((ys, np.minimum(xs + 1, W - 1)), (ys, np.maximum(xs - 1, 0)),
           (np.minimum(ys + 1, H - 1), xs), (np.maximum(ys - 1, 0), xs))
    flux = np.zeros_like(L)
    for y, x in nbs:
        Ln, gn = L[:, y][:, :, x], g[:, y][:, :, x]
        flux = flux + (np.float32(0.5) * (g + gn)) * (Ln - L)
    return L + np.float32(tau) * flux


@pytest.mark.parametrize("shape", [(2, 7, 9), (1, 1, 5), (3, 12, 4), (1, 6, 1)])
def test_fed_step_plain_is_the_documented_order(shape):
    L, g = step_inputs(shape, 5)
    for tau in (LAST_CYCLE[0], LAST_CYCLE[-1], 0.1):
        got = kaze_kernels.fed_step_plain(L, g, tau).numpy()
        assert np.array_equal(got, numpy_step(L.numpy(), g.numpy(), tau)), tau


def _meta_g(L, g):
    return L, torch.empty(g.shape, device="meta")


@pytest.mark.parametrize("bad", [
    lambda L, g: (L.double(), g.double()),
    lambda L, g: (L, g[:, :-1]),
    lambda L, g: (L.transpose(1, 2), g.transpose(1, 2)),
    _meta_g,
], ids=["float64", "g_shape", "non_contiguous", "mixed_devices"])
def test_fed_step_raises(bad):
    with pytest.raises(ValueError, match="fed_step"):
        kaze_kernels.fed_step(*bad(*step_inputs((2, 6, 6), 1)), 0.5)


def test_fed_step_on_the_cpu_is_the_plain_version():
    L, g = step_inputs((2, 9, 11), 3)
    before = trace.launch_counts()
    assert "fed_step" in before
    for tau in LAST_CYCLE:
        assert torch.equal(kaze_kernels.fed_step(L, g, tau), kaze_kernels.fed_step_plain(L, g, tau))
    assert trace.launch_counts()["fed_step"] == before["fed_step"]


def scale_space_record(img):
    """(levels, the recorded stitch) of `nonlinear_scale_space(img, SIG)`
    inside a recorded root span."""
    records = []
    undo = trace.subscribe(records.append)
    try:
        with trace.stitch(["group"], np.zeros((1, 2), np.int32)):
            L = kaze.nonlinear_scale_space(img, SIG)
    finally:
        undo()
    return L, records[0]


def test_scale_space_reaches_the_step(monkeypatch):
    """Every step goes through `_diffusion_step` (what
    `test_bf16_steps_fail` patches) and on to `kernels.kaze.fed_step`: 137
    a group, the `kaze.fed_steps` counter; no kernel launches on the CPU."""
    calls = {"ops": 0, "kernel": 0}
    step, fed_step = kaze._diffusion_step, kaze_kernels.fed_step

    def ops_step(*args):
        calls["ops"] += 1
        return step(*args)

    def kernel_step(*args):
        calls["kernel"] += 1
        return fed_step(*args)

    monkeypatch.setattr(kaze, "_diffusion_step", ops_step)
    monkeypatch.setattr(kaze_kernels, "fed_step", kernel_step)
    img = images(4, G=1, H=24, W=32).float()
    L, rec = scale_space_record(img)
    monkeypatch.undo()
    assert calls == {"ops": 137, "kernel": 137}
    assert rec.counters["kaze.fed_steps"] == 137
    assert "launches.fed_step" not in rec.counters
    assert torch.equal(L, kaze.nonlinear_scale_space(img, SIG))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 600, 800), (6, 600, 800), (1, 7, 9), (3, 37, 131)])
def test_fed_step_on_a_card(shape):
    """The kernel equals the plain version bit for bit at the longest
    cycle's step sizes: float4 loads with a ragged last tile (W = 800), and
    the 4-byte path (odd widths, heights below a tile)."""
    dev = _card()
    L, g = step_inputs(shape, 7, dev)
    for tau in LAST_CYCLE:
        got = kaze_kernels.fed_step(L, g, tau)
        want = kaze_kernels.fed_step_plain(L, g, tau)
        assert torch.equal(got, want), (tau, float((got - want).abs().max()))


@pytest.mark.cuda
def test_scale_space_on_a_card(monkeypatch):
    """A kaze800 group (8 x 600 x 800) through the kernel equals the same
    scale space with the plain step forced, and launches `fed_step` once a
    step: `launches.fed_step` = `kaze.fed_steps` = 137."""
    dev = _card()
    img = images(6, G=8, H=600, W=800).float().to(dev)
    trace.reset_launch_counts()
    L, rec = scale_space_record(img)
    assert rec.counters["launches.fed_step"] == rec.counters["kaze.fed_steps"] == 137
    monkeypatch.setattr(kaze, "_diffusion_step", kaze_kernels.fed_step_plain)
    want = kaze.nonlinear_scale_space(img, SIG)
    assert torch.equal(L, want), float((L - want).abs().max())
