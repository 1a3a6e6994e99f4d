"""The rotational bundle adjustment's normal equations (`kernels/ba.py`,
kernel `ba_normals`) and its bucketed LM phases (`models/bundle.py`).

On the CPU:
- the closed-form Jacobian of the bidirectional residual against
  `torch.func.jacrev` of the residual written as the reference writes it
  (rotations through `so3_exp`, k1 through `undistort_pixels`), at pd 4
  and 5, with matches at the depth guard (|z| < 1e-6, where the clamp
  passes no derivative): rtol 1e-5, atol 1e-6 x each column's scale;
- the plain normal equations against the JAX package's `pair_system` /
  `build_normal_eqns` on `_lm_phase_body`'s inputs (its jacrev Jacobians,
  and the cost `_lm_phase_body` itself returns before an iteration),
  bidirectional and one-direction: rtol 1e-5 of each entry's scale
  sqrt(H_aa H_bb) (float32 sums in another order);
- a bucketed, padded phase against the same phase unpadded: the same
  system bit for bit, and R, f, k1 within 1e-6 after an iteration (only the
  solve's blocking differs; `test_bucketed_phase_matches_unpadded` says
  what a whole phase gives), and a whole phase in float64 equal to
  roundoff;
- a whole phase against the JAX package's `_lm_phase_body`.

On the card (`cuda`-marked, skipped here): the kernel against the plain
version at the ring's and pano100's phase shapes, a repeat launch
bit-identical, a bundle adjustment replayed from CUDA graphs
bit-identical to the same phases run eagerly, and likewise the homography
bundle adjustment's LM (`models/bundle_h.py`, one graph a bucketed shape):

    python -m pytest --noconftest -m cuda tests/test_torch_ba_normals.py -q

The card's machine has no jax: this module imports it only inside the
reference helpers, and imports the `one_torch_thread` fixture from
test_torch_pipeline (which imports jax) only where that import succeeds.
"""

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.config import BundleConfig
from autopanostitch_tpu_torch.kernels import ba as kba
from autopanostitch_tpu_torch.models import bundle as tba
from autopanostitch_tpu_torch.models import bundle_h as tbh
from autopanostitch_tpu_torch.ops import geometry as geo
from autopanostitch_tpu_torch.ops import projections as proj
from autopanostitch_tpu_torch.utils.ba_scene import perturbed_state, planar_scene, ring_scene

try:  # jax-free runs on the card skip the fixture with the jax imports beside it
    from test_torch_pipeline import one_torch_thread  # noqa: F401
except ImportError:
    pass

SIGMA = 2.0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_ba_normals.py on the card")
    return torch.device("cuda")


def _phase(sc, state, dev, active=None, buckets=(64, 8), couple=True, seed_cam=0,
           dtype=torch.float32):
    """One phase's device inputs (`_phase_spec` + `_phase_inputs`) with the
    cameras `active` (all by default), floats in `dtype`."""
    n = len(sc["f"])
    active = np.arange(n) if active is None else np.asarray(active)
    cp = tba._cpinv_focal(active, 200.0, 100.0) if couple else None
    spec = tba._phase_spec(n, sc["pairs"], tba.pair_extents(sc["w"]), active, seed_cam, cp, 0.01,
                           0.002, 1e-3, 8, buckets=buckets)

    def t(a, dtype=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    R, f, k1 = state
    inp = tba._phase_inputs(spec, t(spec.ints, torch.long), t(spec.floats), t(R), t(f), t(k1),
                            t(sc["cx"]), t(sc["cy"]), t(sc["u_i"]), t(sc["u_j"]), t(sc["w"]))
    return spec, inp


def _statics(one_direction=False):
    return tba._statics(BundleConfig(sigma_huber=SIGMA, residual_one_direction=one_direction))


def _normals(inp, pd, one_direction=False, fn=kba.ba_normals):
    return fn(inp["Rb"], inp["f"], inp["k1"], inp["cx"], inp["cy"], inp["u_i"], inp["u_j"],
              inp["w"], inp["pij"], pd, SIGMA, one_direction)


# --- the residual as the reference writes it, for torch.func.jacrev -------

def _ref_project(ps, pdst, Rb_s, Rb_d, cx_s, cy_s, cx_d, cy_d, u_src):
    R_s = geo.so3_exp(ps[:3]) @ Rb_s
    R_d = geo.so3_exp(pdst[:3]) @ Rb_d
    if ps.shape[0] > 4:
        u_src = torch.stack(proj.undistort_pixels(u_src[0], u_src[1], ps[4], cx_s, cy_s))
    x = (u_src[0] - cx_s) / ps[3]
    y = (u_src[1] - cy_s) / ps[3]
    p = R_d @ (R_s.T @ torch.stack([x, y, torch.ones_like(x)]))
    z = p[2]
    z_safe = torch.where(z.abs() < 1e-6, torch.where(z < 0, -1e-6, 1e-6), z)
    return torch.stack([pdst[3] * p[0] / z_safe + cx_d, pdst[3] * p[1] / z_safe + cy_d]), z


def _ref_residual(pp, Rb_i, Rb_j, cx_i, cy_i, cx_j, cy_j, u_i, u_j):
    pd = pp.shape[0] // 2
    p_i, p_j = pp[:pd], pp[pd:]
    pred_j, z_j = _ref_project(p_i, p_j, Rb_i, Rb_j, cx_i, cy_i, cx_j, cy_j, u_i)
    pred_i, z_i = _ref_project(p_j, p_i, Rb_j, Rb_i, cx_j, cy_j, cx_i, cy_i, u_j)
    if pd > 4:
        u_j = torch.stack(proj.undistort_pixels(u_j[0], u_j[1], p_j[4], cx_j, cy_j))
        u_i = torch.stack(proj.undistort_pixels(u_i[0], u_i[1], p_i[4], cx_i, cy_i))
    r = torch.cat([u_j - pred_j, u_i - pred_i])
    return r, (r, torch.stack([z_j, z_i]))


def _match_inputs(pd, seed=0):
    """Per-match camera data of a ring scene's matches, with matches planted
    at the depth guard: camera j turned 90 degrees from camera i, and the
    source point on camera i's principal column (z = 0 exactly, and a
    sub-1e-6 negative z)."""
    sc = ring_scene(8, 2, 12, seed=seed)
    R, f, k1 = perturbed_state(sc, seed=seed + 1, k1=0.03 if pd == 5 else 0.0)
    keep = sc["w"].reshape(-1) > 0
    ii = np.repeat(sc["pairs"][:, 0], sc["w"].shape[1])[keep]
    jj = np.repeat(sc["pairs"][:, 1], sc["w"].shape[1])[keep]
    cols = dict(Rb_i=R[ii], Rb_j=R[jj], f_i=f[ii], f_j=f[jj], k1_i=k1[ii], k1_j=k1[jj],
                cx_i=sc["cx"][ii], cy_i=sc["cy"][ii], cx_j=sc["cx"][jj], cy_j=sc["cy"][jj],
                u_i=sc["u_i"].reshape(-1, 2)[keep], u_j=sc["u_j"].reshape(-1, 2)[keep])
    quarter = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    for m, dx in ((0, 0.0), (1, -1e-7 * 600.0)):
        cols["Rb_i"][m] = np.eye(3, dtype=np.float32)
        cols["Rb_j"][m] = quarter
        cols["k1_i"][m] = 0.0
        cols["u_i"][m] = (cols["cx_i"][m] + np.float32(dx), 100.0)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cols.items()}


@pytest.mark.parametrize("pd", [4, 5])
def test_closed_form_jacobian_matches_jacrev(pd):
    c = _match_inputs(pd)
    r, J, z = kba.pair_residual_jac(c["Rb_i"], c["Rb_j"], c["f_i"], c["f_j"], c["k1_i"],
                                    c["k1_j"], c["cx_i"], c["cy_i"], c["cx_j"], c["cy_j"],
                                    c["u_i"], c["u_j"], pd)
    zero3 = torch.zeros(len(c["f_i"]), 3)
    cam_i = [zero3, c["f_i"][:, None]] + ([c["k1_i"][:, None]] if pd == 5 else [])
    cam_j = [zero3, c["f_j"][:, None]] + ([c["k1_j"][:, None]] if pd == 5 else [])
    pp = torch.cat(cam_i + cam_j, 1)
    jac = torch.func.vmap(torch.func.jacrev(_ref_residual, has_aux=True))
    J_ref, (r_ref, z_ref) = jac(pp, c["Rb_i"], c["Rb_j"], c["cx_i"], c["cy_i"], c["cx_j"],
                                c["cy_j"], c["u_i"], c["u_j"])
    assert J.shape == J_ref.shape == (len(pp), 4, 2 * pd)
    assert (z_ref[:2, 0].abs() < 1e-6).all()  # the planted matches sit at the guard
    np.testing.assert_allclose(z.numpy(), z_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), r_ref.numpy(), rtol=1e-5, atol=1e-3)
    for sl in (slice(0, 2), slice(2, None)):  # the guard's matches, then the others
        got, ref = J[sl].numpy(), J_ref[sl].numpy()
        scale = np.abs(ref).max(axis=(0, 1))  # each column's scale
        err = np.abs(got - ref) - 1e-5 * np.abs(ref) - 1e-6 * scale
        assert (err <= 0).all(), float(err.max())


# --- the JAX package's normal equations on _lm_phase_body's inputs ---------

def _jax_phase(spec, inp, pd, one_direction, iters=0):
    """The JAX package's pair_system / build_normal_eqns (as
    `_lm_phase_body` builds them: its `_pair_residual`, jacrev over the
    matches, `_huber_w`) on a phase's inputs, and `_lm_phase_body` itself
    run for `iters` iterations on the same phase. Returns numpy (JtJ (pb,
    2pd, 2pd), Jtg (pb, 2pd), cost (pb,), H, g) and the body's (R, f, k1,
    cost)."""
    import functools

    import jax
    import jax.numpy as jnp

    from autopanostitch_tpu.models import bundle as jba

    a = {k: jnp.asarray(v.numpy()) for k, v in inp.items()}
    nb, pb = spec.nb, spec.pb
    Rb, f, k1, cx, cy = a["Rb"], a["f"], a["k1"], a["cx"], a["cy"]
    pij = a["pij"].astype(jnp.int32)
    hi = jax.lax.Precision.HIGHEST
    with jax.default_matmul_precision("highest"):
        jac_fn = jax.vmap(jax.jacrev(
            lambda pp, Rbi, Rbj, cxi, cyi, cxj, cyj, ui, uj: jba._pair_residual(
                pp[:pd], pp[pd:], Rbi, Rbj, cxi, cyi, cxj, cyj, ui, uj)[0]),
            in_axes=(None,) * 7 + (0, 0))
        res_fn = jax.vmap(jba._pair_residual, in_axes=(None,) * 8 + (0, 0))

        def cam(i):
            return jnp.concatenate([jnp.zeros(3), f[i][None]] + ([k1[i][None]] if pd == 5 else []))

        def pair_system(p):
            i, j = pij[p, 0], pij[p, 1]
            args = (Rb[i], Rb[j], cx[i], cy[i], cx[j], cy[j], a["u_i"][p], a["u_j"][p])
            r, z = res_fn(cam(i), cam(j), *args)
            J = jac_fn(jnp.concatenate([cam(i), cam(j)]), *args)
            w_ij = jba._huber_w(jnp.sum(r[:, :2] ** 2, -1), SIGMA)
            w_ji = jba._huber_w(jnp.sum(r[:, 2:] ** 2, -1), SIGMA)
            if one_direction:
                w_ji = jnp.zeros_like(w_ji)
            front = (z[:, 0] > 1e-4) & (z[:, 1] > 1e-4)
            w4 = jnp.stack([w_ij, w_ij, w_ji, w_ji], -1) * (a["w"][p] * front)[:, None]
            Jw = J * w4[:, :, None]
            return (jnp.einsum("mab,mac->bc", Jw, J, precision=hi),
                    jnp.einsum("mab,ma->b", Jw, r, precision=hi), jnp.sum(w4 * r * r))

        JtJ, Jtg, cost = jax.vmap(pair_system)(jnp.arange(pb))
    idx = (pij[:, :, None] * pd + jnp.arange(pd)).reshape(pb, 2 * pd)
    H = jnp.zeros((pd * nb, pd * nb)).at[idx[:, :, None], idx[:, None, :]].add(JtJ)
    g = jnp.zeros(pd * nb).at[idx].add(Jtg)

    data = jba.BAData(pair_ij=jnp.zeros((pb, 2), jnp.int32), u_i=a["u_i"], u_j=a["u_j"],
                      w=a["w"], pair_valid=jnp.ones(pb, bool))
    c = BundleConfig()
    body = jax.jit(functools.partial(
        jba._lm_phase_body, nb=nb, pb=pb, iters=iters, pd=pd, sigma=SIGMA,
        f_lo=float(c.focal_clamp[0]), f_hi=float(c.focal_clamp[1]),
        theta_prior=float(c.theta_prior), focal_prior_frac=float(c.focal_prior_frac),
        max_rot_deg=float(c.max_rotation_step_deg), one_direction=one_direction))
    out = body(Rb, f, k1, cx, cy, data, jnp.arange(nb, dtype=jnp.int32), a["cam_ok"] > 0,
               jnp.arange(pb, dtype=jnp.int32), pij, jnp.ones(pb, bool), a["cpinv"],
               jnp.int32(int(np.argmax(inp["seed"].numpy()))), a["lam0"],
               focal_frac=a["focal_frac"], k1_cap=a["k1_cap"])
    ours = tuple(np.asarray(x) for x in (JtJ, Jtg, cost, H, g))
    return ours, tuple(np.asarray(x) for x in (out[0], out[1], out[2], out[4]))


def _close_scaled(got, ref, diag_got, rtol, what):
    """|got - ref| <= rtol x sqrt(d_a d_b) for matrices, rtol x sqrt(d_a) x
    cost-scale for vectors: the Cauchy-Schwarz scale of each entry."""
    err = np.abs(got - ref)
    assert np.isfinite(got).all(), what
    assert (err <= rtol * diag_got + 1e-30).all(), (what, float((err / diag_got).max()))


@pytest.mark.parametrize("pd,one_direction", [(4, False), (5, False), (5, True)])
def test_plain_normal_equations_match_jax(pd, one_direction):
    sc = ring_scene(10, 2, 24, seed=3, size=(240, 320), f=260.0)
    state = perturbed_state(sc, seed=4, k1=0.03 if pd == 5 else 0.0)
    spec, inp = _phase(sc, state, "cpu", active=np.arange(8))  # padded: nb 64, pb 13 -> 16
    assert (spec.nb, spec.pb) == (64, 16) and spec.npair < spec.pb
    JtJ, Jtg, cost = (x.numpy() for x in _normals(inp, pd, one_direction))
    H, g, total = (x.numpy() for x in tba._normal_eqns(inp["Rb"], inp["f"], inp["k1"], inp, pd,
                                                       _statics(one_direction)))
    (jJtJ, jJtg, jcost, jH, jg), body = _jax_phase(spec, inp, pd, one_direction)
    dJ = np.sqrt(np.einsum("pii->pi", jJtJ) + 1e-30)
    _close_scaled(JtJ, jJtJ, dJ[:, :, None] * dJ[:, None, :], 1e-5, "JtJ")
    _close_scaled(Jtg, jJtg, dJ * np.sqrt(jcost + 1e-30)[:, None], 1e-5, "Jtg")
    np.testing.assert_allclose(cost, jcost, rtol=1e-5)
    dH = np.sqrt(np.diag(jH) + 1e-30)
    _close_scaled(H, jH, dH[:, None] * dH[None, :], 1e-5, "H")
    _close_scaled(g, jg, dH * np.sqrt(jcost.sum()), 1e-5, "g")
    # _lm_phase_body's own cost of the phase before its first iteration
    np.testing.assert_allclose(float(total), float(body[3]), rtol=1e-5)


@pytest.mark.parametrize("pd", [4, 5])
def test_lm_phase_matches_jax_body(pd):
    """A whole padded phase (8 iterations) against the reference's
    `_lm_phase_body` on the same inputs. The two solve in float32 in
    another order and LM amplifies that over the iterations (measured: R
    5e-6, f 4e-6 relative, cost 7e-5 relative at pd 5), so the tolerances
    sit a decade above: far inside the golden ones of tests/test_parity.py
    (f rtol 0.005, R atol 0.01)."""
    sc = ring_scene(10, 2, 24, seed=5, size=(240, 320), f=260.0)
    spec, inp = _phase(sc, perturbed_state(sc, seed=6, k1=0.0), "cpu", active=np.arange(7),
                       seed_cam=2)
    Rb, f, k1, cost = tba._lm_phase(inp, pd, 8, _statics())
    _, (jR, jf, jk1, jcost) = _jax_phase(spec, inp, pd, False, iters=8)
    k = len(spec.act)
    np.testing.assert_allclose(f.numpy()[:k], jf[:k], rtol=5e-5)
    np.testing.assert_allclose(Rb.numpy()[:k], jR[:k], atol=5e-5)
    np.testing.assert_allclose(k1.numpy()[:k], jk1[:k], atol=5e-5)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-3)
    # padded cameras keep their gathered state
    np.testing.assert_array_equal(Rb.numpy()[k:], inp["Rb"].numpy()[k:])


@pytest.mark.parametrize("pd", [4, 5])
def test_bucketed_phase_matches_unpadded(pd):
    """Padding adds exact zeros: the padded phase's system equals the
    unpadded one's bit for bit on the active block, and one LM iteration
    gives the same R, f, k1 within 1e-6 (only the Cholesky solve's blocking
    differs with its size). Over a whole phase of 8 iterations far from
    convergence the LM amplifies that rounding (float32 solves of a system
    with condition ~1e6 differ by ~4e-5 relative in either size; measured
    over the phase at pd 4: R 6e-5, f 4e-5 and cost 3e-5 relative): there
    the two are held to 5e-4 (R, k1) and 3e-4 relative (f, cost), a decade
    inside the golden tolerances of tests/test_parity.py. The same phase in
    float64 (`test_bucketed_phase_matches_unpadded_in_float64`) agrees to
    roundoff."""
    sc = ring_scene(12, 2, 32, seed=7, size=(240, 320), f=260.0)
    state = perturbed_state(sc, seed=8, k1=0.02 if pd == 5 else 0.0)
    active = np.array([3, 4, 5, 6, 7, 8, 9])
    k = len(active)
    runs = []
    for buckets in ((64, 8), None):
        spec, inp = _phase(sc, state, "cpu", active=active, buckets=buckets, seed_cam=5)
        H, g, cost = tba._normal_eqns(inp["Rb"], inp["f"], inp["k1"], inp, pd, _statics())
        one = tba._lm_phase(inp, pd, 1, _statics())
        whole = tba._lm_phase(inp, pd, 8, _statics())
        runs.append((spec, H[: k * pd, : k * pd], g[: k * pd], cost, one, whole))
    (sb, H_b, g_b, c_b, one_b, whole_b), (su, H_u, g_u, c_u, one_u, whole_u) = runs
    assert (sb.nb, sb.pb) == (64, 16) and (su.nb, su.pb) == (k, su.npair) == (7, 11)
    assert torch.equal(H_b, H_u) and torch.equal(g_b, g_u) and torch.equal(c_b, c_u)
    for (Rb, f, k1, _), (Ru, fu, k1u, _) in ((one_b, one_u),):
        np.testing.assert_allclose(Rb[:k].numpy(), Ru.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(f[:k].numpy(), fu.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(k1[:k].numpy(), k1u.numpy(), rtol=1e-6, atol=1e-6)
    (Rb, f, k1, cost), (Ru, fu, k1u, cu) = whole_b, whole_u
    assert np.abs(fu.numpy() / state[1][active] - 1).max() > 1e-4  # the phase moved the state
    np.testing.assert_allclose(Rb[:k].numpy(), Ru.numpy(), atol=5e-4)
    np.testing.assert_allclose(f[:k].numpy(), fu.numpy(), rtol=3e-4)
    np.testing.assert_allclose(k1[:k].numpy(), k1u.numpy(), atol=5e-4)
    np.testing.assert_allclose(float(cost), float(cu), rtol=3e-4)


@pytest.mark.parametrize("pd", [4, 5])
def test_bucketed_phase_matches_unpadded_in_float64(pd):
    """The whole 8-iteration phase of `test_bucketed_phase_matches_unpadded`
    in float64: padded and unpadded agree to roundoff (measured: at most
    6e-16 in R, k1 and relative f, cost; held to 1e-12, against the 3e-5 -
    6e-5 of float32), so the padding itself is exact and the float32 gap is
    the solves' rounding."""
    sc = ring_scene(12, 2, 32, seed=7, size=(240, 320), f=260.0)
    state = perturbed_state(sc, seed=8, k1=0.02 if pd == 5 else 0.0)
    active = np.array([3, 4, 5, 6, 7, 8, 9])
    k = len(active)
    runs = []
    for buckets in ((64, 8), None):
        spec, inp = _phase(sc, state, "cpu", active=active, buckets=buckets, seed_cam=5,
                           dtype=torch.float64)
        assert inp["Rb"].dtype == inp["lam0"].dtype == torch.float64
        runs.append(tba._lm_phase(inp, pd, 8, _statics()))
    (Rb, f, k1, cost), (Ru, fu, k1u, cu) = runs
    assert f.dtype == cost.dtype == torch.float64
    assert np.abs(fu.numpy() / state[1][active] - 1).max() > 1e-4  # the phase moved the state
    np.testing.assert_allclose(Rb[:k].numpy(), Ru.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(f[:k].numpy(), fu.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(k1[:k].numpy(), k1u.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(cost), float(cu), rtol=1e-12, atol=0)


def test_ba_normals_checks_its_inputs():
    sc = ring_scene(6, 1, 8)
    _, inp = _phase(sc, perturbed_state(sc), "cpu")
    with pytest.raises(ValueError, match="pd must be 4 or 5"):
        _normals(inp, 3)
    bad = dict(inp, pij=inp["pij"].int())
    with pytest.raises(ValueError, match="int64"):
        _normals(bad, 5)
    bad = dict(inp, u_j=inp["u_j"][:, :-1])
    with pytest.raises(ValueError, match="pb, M, 2"):
        _normals(bad, 5)


def test_run_incremental_ba_recovers_the_ring():
    """The bucketed phases end to end on the CPU: a perturbed 12-view ring
    comes back to its true focal and rotations."""
    sc = ring_scene(12, 2, 40, seed=9, size=(240, 320), f=260.0)
    R0, f0, _ = perturbed_state(sc, seed=10)
    f0[:] = f0.mean()
    order = list(range(12))
    R, f, k1, cost = tba.run_incremental_ba(
        R0, f0, sc["cx"], sc["cy"], sc["u_i"], sc["u_j"], sc["w"], sc["pairs"], order, 0,
        BundleConfig(incremental_lm_iters=8, max_iter_lm=24), with_k1=True, device="cpu")
    assert np.abs(f.numpy() / 260.0 - 1).max() < 5e-3
    rel = R.numpy() @ R.numpy()[0].T  # gauge-free: rotations relative to camera 0
    true = sc["R"] @ sc["R"][0].T
    assert np.abs(rel - true).max() < 5e-3
    assert np.isfinite(float(cost)) and k1.shape == (12,)


# --- on the card -----------------------------------------------------------

# (n cameras, pairs a camera, M): the ring's largest phase (nb 64, pb 64,
# M 300) and pano100's (nb 128, pb 128, M 256)
CARD_SHAPES = {"ring": (20, 3, 300), "pano100": (100, 1, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("pd,one_direction", [(5, False), (4, False), (5, True)])
def test_ba_normals_kernel_matches_plain_on_card(shape, pd, one_direction):
    dev = _cuda()
    n, hops, M = CARD_SHAPES[shape]
    sc = ring_scene(n, hops, M, seed=11)
    spec, inp = _phase(sc, perturbed_state(sc, seed=12, k1=0.03 if pd == 5 else 0.0), dev)
    assert spec.pb == (64 if shape == "ring" else 128)
    got = _normals(inp, pd, one_direction)
    ref = _normals(inp, pd, one_direction, fn=kba.ba_normals_plain)
    again = _normals(inp, pd, one_direction)
    torch.cuda.synchronize()
    for a, b in zip(got, again):  # a repeat launch is bit-identical
        assert torch.equal(a, b)
    JtJ, Jtg, cost = (x.cpu().numpy().astype(np.float64) for x in got)
    rJ, rg, rc = (x.cpu().numpy().astype(np.float64) for x in ref)
    d = np.sqrt(np.einsum("pii->pi", rJ) + 1e-30)
    _close_scaled(JtJ, rJ, d[:, :, None] * d[:, None, :], 1e-5, "JtJ")
    _close_scaled(Jtg, rg, d * np.sqrt(rc + 1e-30)[:, None], 1e-5, "Jtg")
    np.testing.assert_allclose(cost, rc, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(JtJ, np.swapaxes(JtJ, 1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("pd", [5, 4])
def test_graph_replayed_ba_equals_eager_on_card(pd):
    dev = _cuda()
    sc = ring_scene(20, 3, 300, seed=13)
    R0, f0, _ = perturbed_state(sc, seed=14)
    f0[:] = f0.mean()
    args = (R0, f0, sc["cx"], sc["cy"], sc["u_i"], sc["u_j"], sc["w"], sc["pairs"],
            list(range(20)), 0, BundleConfig())
    cfg = args[-1]
    iters = [cfg.incremental_lm_iters] * 19 + [cfg.max_iter_lm // 3 + 1] * 3  # 22 phases
    before = kba.launches
    eager = tba.run_incremental_ba(*args, with_k1=pd == 5, device=dev, graphs=False)
    assert kba.launches - before == sum(i + 1 for i in iters)  # one launch an iteration, + 1
    before = (tba.graph_replays, kba.launches)
    graph = tba.run_incremental_ba(*args, with_k1=pd == 5, device=dev)
    again = tba.run_incremental_ba(*args, with_k1=pd == 5, device=dev)  # cached graphs
    torch.cuda.synchronize()
    assert tba.graph_replays - before[0] == 2 * len(iters)
    assert kba.launches - before[1] >= 2 * sum(i + 1 for i in iters)  # + the captures' warm-ups
    for a, b, c in zip(eager, graph, again):
        if a is None:
            assert b is None and c is None
            continue
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [False, True])
def test_graph_replayed_homography_lm_equals_eager_on_card(bidir):
    """The homography LM of a 3 x 3 planar scan (9 -> 16 cameras, M 300)
    replayed from its CUDA graph equals the same padded LM run eagerly
    (`graphs=False`) bit for bit, with 20 pairs and with 18; both pad to 32
    pairs, so the second problem replays the first one's graph without a
    capture, and the first result, a copy, is left as it was."""
    dev = _cuda()
    sc = planar_scene(3, 3, 300, seed=21)
    cfg = BundleConfig()

    def lm(npairs, graphs):
        args = [torch.as_tensor(sc["params0"], device=dev)]
        args += [torch.as_tensor(sc[k][:npairs], device=dev) for k in ("pairs", "u_i", "u_j", "w")]
        args.append(torch.ones(npairs, dtype=torch.bool, device=dev))
        return tbh.bundle_adjust_h(*args, 4, cfg=cfg, iters=cfg.max_iter_lm, bidir=bidir,
                                   graphs=graphs)

    eager = {n: lm(n, False) for n in (20, 18)}
    first = lm(20, True)
    before = (tba.graph_captures, tba.graph_replays)
    second = lm(18, True)
    torch.cuda.synchronize()
    assert (tba.graph_captures - before[0], tba.graph_replays - before[1]) == (0, 1)
    for n, got in ((20, first), (18, second)):
        assert torch.equal(got[0], eager[n][0]) and torch.equal(got[1], eager[n][1])
    assert (first[0] - torch.as_tensor(sc["params0"], device=dev)).abs().max() > 0.1
