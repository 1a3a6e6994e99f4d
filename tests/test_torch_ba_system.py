"""The rotational bundle adjustment's whole linearisation (`kernels/ba.py`,
kernel `ba_system`) and the phase plan's arrays that steer it
(`models/bundle.py`: each pair's match extent, each camera's incidence
list).

On the CPU:
- `ba_system_plain` (H, g, cost) against the JAX package's
  `build_normal_eqns` on `_lm_phase_body`'s inputs, at pd 4 and 5, with
  and without `residual_one_direction`: rtol 1e-5 of each entry's
  Cauchy-Schwarz scale sqrt(H_aa H_bb) (float32 sums in another order), as
  `test_torch_ba_normals.py` holds the per-pair blocks;
- the phase plan: extents are the last w > 0 slot plus 1 (also with
  interior zeros), each real pair sits once on each of its cameras' lists,
  pairs ascending, padded pairs on none;
- the kernel's decomposition emulated in PyTorch in float64: per-pair sums
  over 16-match chunks up to the extent, one direction a row pair, against
  `ba_normals_plain`; the dense system assembled from the incidence lists
  against the one-hot einsum assembly (also with a repeated and a self
  pair); both to roundoff (1e-12 relative).

On the card (`cuda`-marked, skipped here): the kernel against the plain
version at the ring's and pano100's phase shapes and at a 600-slot shape
whose pairs span three chunk rounds, with zero-weight slots inside the
extents; a repeat launch and a graph replay bit-identical to the eager
launch:

    python -m pytest --noconftest -m cuda tests/test_torch_ba_system.py -q
"""

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.kernels import ba as kba
from autopanostitch_tpu_torch.models import bundle as tba
from autopanostitch_tpu_torch.utils import trace
from autopanostitch_tpu_torch.utils.ba_scene import perturbed_state, ring_scene
from test_torch_ba_normals import (CARD_SHAPES, SIGMA, _close_scaled, _cuda, _jax_phase, _phase,
                                   _statics)

try:  # jax-free runs on the card skip the fixture with the jax imports beside it
    from test_torch_pipeline import one_torch_thread  # noqa: F401
except ImportError:
    pass

CHUNK = 16  # matches a warp of `pair_sums` takes at once (csrc/ba_system.cu kChunk)
SLOTS = 16  # warp slots a pair (kWarps x kCluster)


def _args(inp, pd, one_direction=False):
    return (inp["Rb"], inp["f"], inp["k1"], inp["cx"], inp["cy"], inp["u_i"], inp["u_j"],
            inp["w"], inp["pij"], inp["ext"], inp["inc_off"], inp["inc"], pd, SIGMA,
            one_direction)


@pytest.mark.parametrize("pd,one_direction", [(4, False), (4, True), (5, False), (5, True)])
def test_plain_system_matches_jax(pd, one_direction):
    sc = ring_scene(10, 2, 24, seed=3, size=(240, 320), f=260.0)
    state = perturbed_state(sc, seed=4, k1=0.03 if pd == 5 else 0.0)
    spec, inp = _phase(sc, state, "cpu", active=np.arange(8))  # padded: nb 64, pb 13 -> 16
    assert (spec.nb, spec.pb) == (64, 16) and spec.npair < spec.pb
    H, g, cost = (x.numpy() for x in kba.ba_system_plain(*_args(inp, pd, one_direction)))
    (_, _, jcost, jH, jg), body = _jax_phase(spec, inp, pd, one_direction)
    assert H.shape == jH.shape == (pd * spec.nb, pd * spec.nb) and g.shape == jg.shape
    dH = np.sqrt(np.diag(jH) + 1e-30)
    _close_scaled(H, jH, dH[:, None] * dH[None, :], 1e-5, "H")
    _close_scaled(g, jg, dH * np.sqrt(jcost.sum()), 1e-5, "g")
    np.testing.assert_allclose(float(cost), float(jcost.sum()), rtol=1e-5)
    if not one_direction:  # _lm_phase_body's own cost of the phase before its first iteration
        np.testing.assert_allclose(float(cost), float(body[3]), rtol=1e-5)


def test_cpu_ba_system_is_its_plain_version():
    """On the CPU the wrapper is the plain version, bit for bit: the LM's
    CPU results keep the numbers of the per-pair kernel + einsum path."""
    sc = ring_scene(8, 2, 20, seed=1, size=(240, 320), f=260.0)
    _, inp = _phase(sc, perturbed_state(sc, seed=2), "cpu")
    got = kba.ba_system(*_args(inp, 5))
    ref = kba.ba_system_plain(*_args(inp, 5))
    E = kba.camera_map(inp["pij"], inp["Rb"].shape[0], torch.float32)
    old = kba.assemble_plain(*kba.ba_normals_plain(*_args(inp, 5)[:9], 5, SIGMA, False), E)
    for a, b, c in zip(got, ref, old):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_pair_extents():
    w = np.zeros((5, 8), np.float32)
    w[0, :3] = 1.0  # packed at the front
    w[1, [0, 2, 6]] = 1.0  # interior zeros
    w[2, 7] = 0.5  # the last slot only
    w[4] = 1.0  # full; row 3 has none
    assert tba.pair_extents(w).tolist() == [3, 7, 8, 0, 8]
    assert tba.pair_extents(w).dtype == np.int64


@pytest.mark.parametrize("buckets", [(64, 8), None])
def test_phase_plan_extents_and_incidence_lists(buckets):
    sc = ring_scene(12, 3, 20, seed=5, size=(240, 320), f=260.0)
    rng = np.random.default_rng(0)
    w = sc["w"] * (rng.random(sc["w"].shape) > 0.3)  # interior zeros
    w[4] = 0.0  # a real pair with no match left
    ext = tba.pair_extents(w)
    active = np.array([0, 2, 3, 4, 5, 7, 9, 10])
    spec = tba._phase_spec(12, sc["pairs"], ext, active, 2, None, 0.01, 0.002, 1e-3, 4,
                           buckets=buckets)
    nb, pb, q = spec.nb, spec.pb, spec.npair
    cam_take, pair_take, pij, e, inc_off, inc = np.split(
        spec.ints, np.cumsum([nb, pb, 2 * pb, pb, nb + 1]))
    pij = pij.reshape(pb, 2)
    assert len(inc) == 2 * pb and len(inc_off) == nb + 1 and q < len(sc["pairs"])
    # extents: the last w > 0 slot + 1 of each real pair, 0 for padding
    for p in range(pb):
        real = np.nonzero(w[pair_take[p]] > 0)[0] if p < q else []
        assert e[p] == (real[-1] + 1 if len(real) else 0)
    assert (e[q:] == 0).all() and (pb == q) == (buckets is None)
    # each camera's list: (pair, side) entries whose camera it is, pairs ascending
    assert inc_off[0] == 0 and inc_off[-1] == 2 * q and (np.diff(inc_off) >= 0).all()
    seen = np.zeros(2 * q, int)
    for a in range(nb):
        entries = inc[inc_off[a]:inc_off[a + 1]]
        pairs, sides = entries // 2, entries % 2
        assert (pairs < q).all()  # padded pairs are on no list
        assert (np.diff(pairs) > 0).all()  # ascending, each pair once a list
        assert (pij[pairs, sides] == a).all()
        np.add.at(seen, entries, 1)
        assert a < len(active) or len(entries) == 0  # padded cameras have no pair
    assert (seen == 1).all()  # every real pair once on each of its two cameras' lists


def _chunked_records(inp, pd, sigma, one_direction):
    """The pairs' records as `pair_sums` forms them, in float64: over each
    pair's extent only, in chunks of CHUNK matches, each direction's two
    rows summed apart, chunk c into slot c % SLOTS, the slots summed in
    order. Returns JtJ (pb, 2pd, 2pd), Jtg (pb, 2pd), cost (pb,)."""
    ii, jj = inp["pij"][:, 0], inp["pij"][:, 1]

    def cam(t, idx):
        return t[idx][:, None]

    r, J, z = kba.pair_residual_jac(
        cam(inp["Rb"], ii), cam(inp["Rb"], jj), cam(inp["f"], ii), cam(inp["f"], jj),
        cam(inp["k1"], ii), cam(inp["k1"], jj), cam(inp["cx"], ii), cam(inp["cy"], ii),
        cam(inp["cx"], jj), cam(inp["cy"], jj), inp["u_i"], inp["u_j"], pd)
    front = ((z[..., 0] > 1e-4) & (z[..., 1] > 1e-4)).to(r.dtype)
    pb, M = inp["w"].shape
    n2 = 2 * pd
    out = torch.zeros(pb, n2 * n2 + n2 + 1, dtype=r.dtype)
    for p in range(pb):
        e = min(int(inp["ext"][p]), M)
        nch = -(-e // CHUNK)
        slots = torch.zeros(SLOTS, n2 * n2 + n2 + 1, dtype=r.dtype)
        for c in range(nch):
            part = torch.zeros_like(slots[0])
            for m in range(c * CHUNK, min(e, (c + 1) * CHUNK)):
                for d in range(2):  # direction i -> j (rows 0, 1), j -> i (rows 2, 3)
                    rr, JJ = r[p, m, 2 * d:2 * d + 2], J[p, m, 2 * d:2 * d + 2]
                    hub = 0.0 if (d and one_direction) else float(kba.huber_w((rr ** 2).sum(),
                                                                              sigma))
                    wv = hub * inp["w"][p, m] * front[p, m]
                    part += torch.cat([(wv * JJ.T @ JJ).reshape(-1), wv * JJ.T @ rr,
                                       (wv * rr @ rr)[None]])
            slots[c % SLOTS] += part
        out[p] = slots[:min(nch, SLOTS)].sum(0)
    return out[:, :n2 * n2].reshape(pb, n2, n2), out[:, n2 * n2:-1], out[:, -1]


@pytest.mark.parametrize("pd,one_direction", [(4, False), (5, False), (5, True)])
def test_chunked_pair_sums_match_plain_in_float64(pd, one_direction):
    """Sums over the extent in chunks equal sums over every slot: the
    slots past a pair's extent and the zero-weight ones inside it add
    nothing."""
    sc = ring_scene(8, 2, 40, seed=6, size=(240, 320), f=260.0, fill=0.9)
    rng = np.random.default_rng(1)
    sc["w"] = (sc["w"] * (rng.random(sc["w"].shape) > 0.25)).astype(np.float32)
    _, inp = _phase(sc, perturbed_state(sc, seed=7, k1=0.03 if pd == 5 else 0.0), "cpu",
                    dtype=torch.float64)
    assert int(inp["ext"].max()) > 2 * CHUNK and (inp["ext"] < 40).all()
    got = _chunked_records(inp, pd, SIGMA, one_direction)
    ref = kba.ba_normals_plain(*_args(inp, pd)[:9], pd, SIGMA, one_direction)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


def _assemble_lists(JtJ, Jtg, cost, pij, inc_off, inc, nb):
    """The dense system as `assemble` builds it: H's block (a, b) the sum,
    over camera a's list in order, of each entry's pair block (side, t) for
    each side t on camera b; g likewise; the cost over the pairs in order."""
    pd = JtJ.shape[-1] // 2
    H = torch.zeros(pd * nb, pd * nb, dtype=JtJ.dtype)
    g = torch.zeros(pd * nb, dtype=JtJ.dtype)
    for a in range(nb):
        rows = slice(a * pd, (a + 1) * pd)
        for en in inc[inc_off[a]:inc_off[a + 1]].tolist():
            p, s = divmod(en, 2)
            for t in range(2):
                b = int(pij[p, t])
                H[rows, b * pd:(b + 1) * pd] += JtJ[p, s * pd:(s + 1) * pd, t * pd:(t + 1) * pd]
            g[rows] += Jtg[p, s * pd:(s + 1) * pd]
    total = torch.zeros((), dtype=cost.dtype)
    for c in cost:
        total = total + c
    return H, g, total


@pytest.mark.parametrize("pd", [4, 5])
def test_list_assembly_matches_einsum_in_float64(pd):
    sc = ring_scene(10, 2, 24, seed=8, size=(240, 320), f=260.0)
    spec, inp = _phase(sc, perturbed_state(sc, seed=9), "cpu", active=np.arange(1, 9),
                       dtype=torch.float64)
    assert spec.npair < spec.pb  # padded pairs: zero blocks, on no list
    blocks = kba.ba_normals_plain(*_args(inp, pd)[:9], pd, SIGMA, False)
    E = kba.camera_map(inp["pij"], spec.nb, torch.float64)
    ref = kba.assemble_plain(*blocks, E)
    got = _assemble_lists(*blocks, inp["pij"], inp["inc_off"], inp["inc"], spec.nb)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))
    # a pair given twice and a pair of one camera with itself: every block adds
    rng = np.random.default_rng(2)
    pairs = np.array([[0, 1], [1, 2], [0, 1], [2, 2], [3, 0], [1, 3]])
    spec = tba._phase_spec(4, pairs, np.full(6, 5), np.arange(4), 0, None, 0.01, 0.002, 1e-3, 1)
    nb, pb, q = spec.nb, spec.pb, spec.npair
    _, _, pij, _, inc_off, inc = np.split(spec.ints, np.cumsum([nb, pb, 2 * pb, pb, nb + 1]))
    pij = torch.as_tensor(pij).view(pb, 2)
    A = torch.as_tensor(rng.standard_normal((pb, 2 * pd, 2 * pd)))
    JtJ = (A @ A.transpose(1, 2)) * (torch.arange(pb) < q)[:, None, None]
    Jtg = torch.as_tensor(rng.standard_normal((pb, 2 * pd))) * (torch.arange(pb) < q)[:, None]
    cost = torch.as_tensor(rng.random(pb)) * (torch.arange(pb) < q)
    ref = kba.assemble_plain(JtJ, Jtg, cost, kba.camera_map(pij, nb, torch.float64))
    got = _assemble_lists(JtJ, Jtg, cost, pij, torch.as_tensor(inc_off), torch.as_tensor(inc),
                          nb)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


def test_ba_system_checks_its_inputs():
    sc = ring_scene(6, 1, 8)
    _, inp = _phase(sc, perturbed_state(sc), "cpu")
    with pytest.raises(ValueError, match="ba_system: pd must be 4 or 5"):
        kba.ba_system(*_args(inp, 3))
    with pytest.raises(ValueError, match="int64"):
        kba.ba_system(*_args(dict(inp, ext=inp["ext"].int()), 5))
    with pytest.raises(ValueError, match="inc_off"):
        kba.ba_system(*_args(dict(inp, inc_off=inp["inc_off"][:-1]), 5))
    with pytest.raises(ValueError, match="pij"):
        kba.ba_system(*_args(dict(inp, pij=inp["pij"][:-1]), 5))


# --- on the card -----------------------------------------------------------

# CARD_SHAPES and a shape whose extents reach 540 of 600 slots: up to 34
# chunks a pair, three rounds of the 16 warp slots
SHAPES = dict(CARD_SHAPES, long=(8, 2, 600))


def _card_phase(shape, pd, dev):
    n, hops, M = SHAPES[shape]
    sc = ring_scene(n, hops, M, seed=11, fill=0.9 if shape == "long" else 0.8)
    rng = np.random.default_rng(12)
    sc["w"] = (sc["w"] * (rng.random(sc["w"].shape) > 0.2)).astype(np.float32)  # interior zeros
    return _phase(sc, perturbed_state(sc, seed=12, k1=0.03 if pd == 5 else 0.0), dev)


def _ba_launches():
    """`ba_system`'s launches that ran, and those recorded into graphs being
    captured."""
    return (trace.launch_counts()["ba_system"],
            trace.launch_counts(captured=True).get("ba_system", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("pd,one_direction", [(5, False), (4, False), (5, True)])
def test_ba_system_kernel_matches_plain_on_card(shape, pd, one_direction):
    dev = _cuda()
    spec, inp = _card_phase(shape, pd, dev)
    if shape == "long":
        assert int(inp["ext"].max()) > 2 * SLOTS * CHUNK
    before = trace.launch_counts()["ba_system"]
    got = kba.ba_system(*_args(inp, pd, one_direction))
    again = kba.ba_system(*_args(inp, pd, one_direction))
    ref = kba.ba_system_plain(*_args(inp, pd, one_direction))
    torch.cuda.synchronize()
    assert trace.launch_counts()["ba_system"] - before == 2
    for a, b in zip(got, again):  # a repeat launch is bit-identical
        assert torch.equal(a, b)
    H, g, cost = (x.cpu().numpy().astype(np.float64) for x in got)
    rH, rg, rc = (x.cpu().numpy().astype(np.float64) for x in ref)
    assert H.shape == (pd * spec.nb, pd * spec.nb)
    d = np.sqrt(np.clip(np.diag(rH), 0, None) + 1e-30)
    _close_scaled(H, rH, d[:, None] * d[None, :], 1e-5, "H")
    _close_scaled(g, rg, d * np.sqrt(max(float(rc), 0.0) + 1e-30), 1e-5, "g")
    np.testing.assert_allclose(float(cost), float(rc), rtol=1e-5)
    np.testing.assert_array_equal(H, H.T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ring", "pano100"])
def test_ba_system_graph_replay_equals_eager_on_card(shape):
    dev = _cuda()
    _, inp = _card_phase(shape, 5, dev)
    eager = kba.ba_system(*_args(inp, 5))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _ba_launches()
    with torch.cuda.graph(graph):
        out = kba.ba_system(*_args(inp, 5))
    assert _ba_launches() == (before[0], before[1] + 1)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(eager, out):
            assert torch.equal(a, b)
