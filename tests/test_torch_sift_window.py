"""The fused SIFT window kernels (`kernels/sift_window.py`, B2 fused with
the orientation histogram and the descriptor).

On the CPU: the wrappers' plain versions against the JAX package's
`_orientation_hist_dense` and `_descriptor_dense`, `jax.vmap`ped over
`dynamic_slice` windows of the same stack, on identical inputs made with
numpy from a seed (odd W, windows at every image edge, a coarse-octave
window of <= 32 px; the default 4 x 4 x 8 descriptor grid and others).
Tolerances: histogram rtol 1e-5 (float32 sums in another order);
descriptor max 3e-5 and mean 1e-6: XLA's and PyTorch's CPU `exp` and
`sin` differ by an ulp on some inputs, and where that moves a weight
across a bf16 rounding boundary one pixel's operand changes by a bf16 ulp
(1.8e-5 at most in these cases; 1e-8 on average). Then the wrappers' input
checks, and `stitch` refusing, before any work, a descriptor grid that
the card's kernels do not take.

On the card (`cuda`-marked, skipped here) the kernels against the plain
versions (every copy route, several grids), and repeat launches
bit-identical:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py \\
        tests/test_torch_sift_window.py -q

The card's machine has no jax: this module imports it only inside the
reference helper.
"""

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.kernels import sift_window as sw
from autopanostitch_tpu_torch.utils import trace

try:  # jax-free runs on the card skip the fixture with the jax imports beside it
    from test_torch_pipeline import one_torch_thread  # noqa: F401
except ImportError:
    pass

# (levels, H, W, win, K): the orientation (40) and descriptor (80) windows
# of octave 0, an odd-W coarse octave with a 32 px window, and a 24 px one
CASES = {
    "win40": (6, 96, 128, 40, 300),
    "win80": (4, 100, 120, 80, 120),
    "odd_w_coarse32": (5, 38, 51, 32, 200),
    "odd_w_win24": (3, 45, 67, 24, 150),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_sift_window.py on the card")
    return torch.device("cuda")


def _case(seed, S, H, W, win, K):
    """A (S, H, W, 2) magnitude/angle stack (mag >= 0, angle in (-pi, pi],
    with exact +-pi, 0 and tiny negative angles planted) and K keypoints:
    random windows with the first few on every edge, in-window positions,
    sigma_rel in [1.6, 3.5], theta in [0, 2 pi)."""
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal((S, H, W))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (S, H, W)).astype(np.float32)
    flat = ang.reshape(-1)
    spots = rng.choice(flat.size, 64, replace=False)
    flat[spots] = np.array([np.pi, -np.pi, 0.0, -1e-9], np.float32)[np.arange(64) % 4]
    ang = np.where(ang <= -np.float32(np.pi), np.float32(np.pi), ang)  # atan2's range
    src = np.ascontiguousarray(np.stack([mag, ang], -1))
    lev = rng.integers(0, S, K).astype(np.int32)
    ys = rng.integers(0, H - win + 1, K).astype(np.int32)
    xs = rng.integers(0, W - win + 1, K).astype(np.int32)
    edges = [(0, None), (H - win, None), (None, 0), (None, W - win), (0, 0), (H - win, W - win)]
    for k, (y, x) in enumerate(edges[:K]):
        ys[k] = ys[k] if y is None else y
        xs[k] = xs[k] if x is None else x
    lx = rng.uniform(0, win - 1, K).astype(np.float32)
    ly = rng.uniform(0, win - 1, K).astype(np.float32)
    srel = rng.uniform(1.6, 3.5, K).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, K).astype(np.float32)
    return src, lev, ys, xs, lx, ly, srel, theta


def _torch(arrs, dev="cpu"):
    return [torch.as_tensor(a, device=dev) for a in arrs]


def _jax_windows(fn, src, lev, ys, xs, win, *args):
    """The JAX package's dense phase `fn` vmapped over dynamic_slice windows."""
    import jax
    import jax.numpy as jnp

    src_j = jnp.asarray(src)

    def one(l, y, x, *a):
        w = jax.lax.dynamic_slice(src_j, (l, y, x, 0), (1, win, win, 2))[0]
        return fn(w[..., 0], w[..., 1], *a)

    return np.asarray(jax.vmap(one)(*[jnp.asarray(a) for a in (lev, ys, xs) + args]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_orient_hist_matches_jax(name):
    from autopanostitch_tpu.ops import sift as jsift

    S, H, W, win, K = CASES[name]
    src, lev, ys, xs, lx, ly, srel, _ = _case(1, S, H, W, win, K)
    raw = sw.orient_hist(*_torch((src, lev, ys, xs, lx, ly, srel)), win)
    assert raw.shape == (K, 36) and (raw >= 0).all()
    ref = _jax_windows(jsift._orientation_hist_dense, src, lev, ys, xs, win, lx, ly, srel)
    np.testing.assert_allclose(sw.smooth_hist(raw).numpy(), ref, rtol=1e-5, atol=0)


def _descriptor_vs_jax(name, d, nbins):
    from autopanostitch_tpu.ops import sift as jsift

    S, H, W, win, K = CASES[name]
    src, lev, ys, xs, lx, ly, srel, theta = _case(2, S, H, W, win, K)
    got = sw.descriptor(*_torch((src, lev, ys, xs, lx, ly, srel, theta)), win, d, nbins)
    assert got.shape == (K, d * d * nbins)
    ref = _jax_windows(lambda m, a, *r: jsift._descriptor_dense(m, a, *r, d, nbins),
                       src, lev, ys, xs, win, lx, ly, srel, theta)
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 3e-5 and diff.mean() <= 1e-6, (diff.max(), diff.mean())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_descriptor_matches_jax(name):
    _descriptor_vs_jax(name, 4, 8)


@pytest.mark.parametrize("d,nbins", [(2, 4), (3, 6), (4, 12)])
def test_plain_descriptor_other_grids_match_jax(d, nbins):
    _descriptor_vs_jax("win40", d, nbins)


def test_plain_versions_do_not_depend_on_the_chunk():
    src, lev, ys, xs, lx, ly, srel, theta = _torch(_case(3, *CASES["odd_w_win24"]))
    win = CASES["odd_w_win24"][3]
    for chunk in (1, 7):
        torch.testing.assert_close(sw.orient_hist(src, lev, ys, xs, lx, ly, srel, win, chunk=chunk),
                                   sw.orient_hist(src, lev, ys, xs, lx, ly, srel, win),
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(
            sw.descriptor(src, lev, ys, xs, lx, ly, srel, theta, win, chunk=chunk),
            sw.descriptor(src, lev, ys, xs, lx, ly, srel, theta, win), rtol=0, atol=1e-6)


def test_empty_keypoint_lists():
    src, lev, ys, xs, lx, ly, srel, theta = _torch(_case(4, *CASES["win40"]))
    e = slice(0, 0)
    assert sw.orient_hist(src, lev[e], ys[e], xs[e], lx[e], ly[e], srel[e], 40).shape == (0, 36)
    assert sw.descriptor(src, lev[e], ys[e], xs[e], lx[e], ly[e], srel[e], theta[e],
                         40).shape == (0, 128)


def test_wrappers_reject_bad_inputs():
    S, H, W, win, K = CASES["win40"]
    src, lev, ys, xs, lx, ly, srel, theta = _torch(_case(5, S, H, W, win, K))

    def both(**kw):
        a = dict(src=src, lev=lev, ys=ys, xs=xs, lx=lx, ly=ly, sigma_rel=srel, win=win)
        a.update(kw)
        with pytest.raises(ValueError):
            sw.orient_hist(**a)
        with pytest.raises(ValueError):
            sw.descriptor(theta=theta, **a)

    both(src=src.double())                          # dtype
    both(src=src[..., :1].contiguous())             # shape
    both(lev=lev.long())                            # index dtype
    both(lx=lx.double())                            # per-keypoint dtype
    both(ly=ly[:-1])                                # length
    both(win=H + 1)                                 # window larger than the source
    both(ys=ys.clone().fill_(H - win + 1))          # window past the bottom edge
    both(xs=xs.clone().fill_(-1))                   # window before the left edge
    both(lev=lev.clone().fill_(S))                  # no such level
    meta = [t.to("meta") for t in (src, lev, ys, xs, lx, ly, srel)]
    with pytest.raises(ValueError, match="device"):
        sw.orient_hist(*meta, win)                  # neither CPU nor CUDA


def test_copy_route_needs_16_byte_rows():
    src = torch.zeros((2, 50, 64, 2))
    assert sw.copy_route(src, 40) == "tma"
    assert sw.copy_route(torch.zeros((2, 50, 63, 2)), 40) == "cp.async"  # odd W
    assert sw.copy_route(src, 39) == "cp.async"  # odd window
    shifted = torch.zeros(src.numel() + 2)[2:].view(src.shape)  # 8-byte aligned base
    assert sw.copy_route(shifted, 40) == "cp.async"


def test_copy_route_reads_the_stack_when_two_stages_do_not_fit():
    src = torch.zeros((2, 130, 150, 2))
    assert sw.copy_route(src, 104, "descriptor") == "tma"
    assert sw.copy_route(src, 112, "descriptor") == "direct"
    assert sw.copy_route(src, 88, "descriptor", nbins=16) == "tma"  # wider records
    assert sw.copy_route(src, 96, "descriptor", nbins=16) == "direct"
    assert sw.copy_route(src, 112, "orient_hist") == "tma"
    assert sw.copy_route(src, 120, "orient_hist") == "direct"


@pytest.mark.parametrize("d,nbins,error,match", [(5, 8, ValueError, "descriptor"),
                                                 (4, 17, ValueError, "descriptor"),
                                                 (2, 4, RuntimeError, "cuda")],
                         ids=["5-8", "4-17", "2-4"])
def test_stitch_on_cuda_rejects_grids_the_kernels_lack_before_any_work(d, nbins, error, match):
    """A descriptor grid outside the descriptor kernel (d <= 4, nbins <= 16)
    fails at once, whatever the machine, not inside extraction. A grid both
    kernels take passes the checks: 2x2x4 (D = 16), which B1 takes as 32
    zero-padded columns, gets as far as the device (here: none)."""
    from autopanostitch_tpu_torch.api import ImageSet, StitchConfig
    from autopanostitch_tpu_torch.config import DetectorConfig
    from autopanostitch_tpu_torch.models import pipeline

    iset = ImageSet(images=np.zeros((2, 32, 32, 3), np.uint8),
                    sizes=np.full((2, 2), 32, np.int32), names=["a", "b"])
    cfg = StitchConfig(detector=DetectorConfig(descriptor_width=d, descriptor_bins=nbins))
    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the grid would stitch")
    with pytest.raises(error, match=match):
        pipeline.stitch(iset, cfg, device="cuda")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _agree(hist_k, hist_p, desc_k, desc_p):
    """The chip gates: raw histograms within 1e-5 of each row's max,
    descriptors within 1e-4 (max) and 1e-6 (mean)."""
    scale = hist_p.abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert float(((hist_k - hist_p).abs() / scale).max()) <= 1e-5
    diff = (desc_k - desc_p).abs()
    assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-6


def _run_both(dev, S, H, W, win, K, seed=6, src_override=None):
    src, lev, ys, xs, lx, ly, srel, theta = _torch(_case(seed, S, H, W, win, K), dev)
    if src_override is not None:
        src = src_override(src)
    h0, d0 = (trace.launch_counts()[k] for k in ("orient_hist", "descriptor"))
    hist = sw.orient_hist(src, lev, ys, xs, lx, ly, srel, win)
    desc = sw.descriptor(src, lev, ys, xs, lx, ly, srel, theta, win)
    torch.cuda.synchronize()
    assert (trace.launch_counts()["orient_hist"], trace.launch_counts()["descriptor"]) == (
        h0 + 1, d0 + 1)
    return src, (lev, ys, xs, lx, ly, srel, theta), hist, desc


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(name):
    dev = _cuda()
    S, H, W, win, _ = CASES[name]
    src, (lev, ys, xs, lx, ly, srel, theta), hist, desc = _run_both(dev, S, H, W, win, 2000)
    assert sw.copy_route(src, win) == ("tma" if W % 2 == 0 else "cp.async")
    hist_p = sw.orient_hist_plain(src, lev, ys, xs, lx, ly, srel, win)
    desc_p = sw.descriptor_plain(src, lev, ys, xs, lx, ly, srel, theta, win)
    _agree(hist, hist_p, desc, desc_p)
    # repeat launches are bit-identical (no float atomics, fixed sum order)
    assert torch.equal(hist, sw.orient_hist(src, lev, ys, xs, lx, ly, srel, win))
    assert torch.equal(desc, sw.descriptor(src, lev, ys, xs, lx, ly, srel, theta, win))


@pytest.mark.cuda
def test_both_copy_routes_agree_on_card():
    """The same stack at a 16-byte and at an 8-byte aligned base: TMA and
    cp.async copies feed identical arithmetic, so the outputs are equal."""
    dev = _cuda()
    S, H, W, win, _ = CASES["win40"]
    src, args, hist, desc = _run_both(dev, S, H, W, win, 500)

    def shifted(t):
        buf = torch.empty(t.numel() + 2, device=t.device)
        out = buf[2:].view(t.shape)
        out.copy_(t)
        return out

    src2, _, hist2, desc2 = _run_both(dev, S, H, W, win, 500, src_override=shifted)
    assert sw.copy_route(src, win) == "tma" and sw.copy_route(src2, win) == "cp.async"
    assert torch.equal(hist, hist2) and torch.equal(desc, desc2)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1])
def test_kernels_tiny_lists_on_card(K):
    dev = _cuda()
    S, H, W, win, _ = CASES["win80"]
    t = _torch(_case(7, S, H, W, win, K), dev)
    hist, desc = sw.orient_hist(*t[:7], win), sw.descriptor(*t, win)
    assert hist.shape == (K, 36) and desc.shape == (K, 128)
    if K:
        _agree(hist, sw.orient_hist_plain(*t[:7], win), desc, sw.descriptor_plain(*t, win))


@pytest.mark.cuda
def test_kernels_every_window_on_a_border_on_card():
    """Every window flush with an edge or a corner of its level."""
    dev = _cuda()
    S, H, W, win, K = CASES["odd_w_coarse32"]
    src, lev, ys, xs, lx, ly, srel, theta = _case(8, S, H, W, win, 400)
    corner = np.arange(400) % 4
    ys = np.where(corner < 2, 0, H - win).astype(np.int32)
    xs = np.where(corner % 2 == 0, 0, W - win).astype(np.int32)
    t = _torch((src, lev, ys, xs, lx, ly, srel, theta), dev)
    hist = sw.orient_hist(*t[:7], win)
    desc = sw.descriptor(*t, win)
    _agree(hist, sw.orient_hist_plain(*t[:7], win), desc, sw.descriptor_plain(*t, win))


@pytest.mark.cuda
def test_descriptor_kernel_rejects_other_grids_on_card():
    dev = _cuda()
    t = _torch(_case(9, *CASES["win40"]), dev)
    for d, nbins in ((5, 8), (4, 17), (0, 8)):
        with pytest.raises(ValueError, match="descriptor_width"):
            sw.descriptor(*t, 40, d, nbins)


@pytest.mark.cuda
@pytest.mark.parametrize("d,nbins", [(1, 1), (2, 8), (3, 5), (4, 4), (4, 12), (2, 16)])
def test_descriptor_kernel_other_grids_on_card(d, nbins):
    dev = _cuda()
    S, H, W, win, _ = CASES["odd_w_win24" if d == 3 else "win40"]
    t = _torch(_case(10 + d, S, H, W, win, 1500), dev)
    desc = sw.descriptor(*t, win, d, nbins)
    assert desc.shape == (1500, d * d * nbins)
    diff = (desc - sw.descriptor_plain(*t, win, d, nbins)).abs()
    assert float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-6
    assert torch.equal(desc, sw.descriptor(*t, win, d, nbins))


@pytest.mark.cuda
@pytest.mark.parametrize("win", [112, 120])
def test_kernels_direct_route_on_card(win):
    """Windows whose two stages do not fit in shared memory: each thread
    reads the stack (112 px: the descriptor; 120 px: both kernels)."""
    dev = _cuda()
    src, (lev, ys, xs, lx, ly, srel, theta), hist, desc = _run_both(dev, 3, 130, 150, win, 700)
    assert sw.copy_route(src, win, "descriptor") == "direct"
    assert sw.copy_route(src, win) == ("direct" if win > 112 else "tma")
    _agree(hist, sw.orient_hist_plain(src, lev, ys, xs, lx, ly, srel, win),
           desc, sw.descriptor_plain(src, lev, ys, xs, lx, ly, srel, theta, win))
