"""The port's multi-GPU path (`autopanostitch_tpu_torch/parallel/`) on gloo
ranks of the CPU against the JAX package's `parallel/` on its 8 virtual CPU
devices, with tests/test_parallel.py's scenes and tolerances.

The ranks are spawned once for the module (`ranks`): world sizes 1, 2 and
3 at once, each its own process group over a `file://` store under the
test's temporary directory. Each rank runs every case of its world size
and writes its outputs to an npz file; the parametrised tests below
compare them with the JAX package's results, with the port's
single-device functions and across ranks. World size 3 pads: 4 images
over 3 ranks, 200 queries over 3 ranks.
"""

import dataclasses
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import synthdata
from test_torch_pipeline import one_torch_thread  # noqa: F401
from autopanostitch_tpu.utils import real_data as jreal
from autopanostitch_tpu_torch import config as tconfig
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.models import render as trender
from autopanostitch_tpu_torch.ops import matching as tmt
from autopanostitch_tpu_torch.ops import ransac as trs
from autopanostitch_tpu_torch.ops import sampling as tsamp
from autopanostitch_tpu_torch.ops import sift as tsift
from autopanostitch_tpu_torch.parallel import mesh as tmesh
from autopanostitch_tpu_torch.parallel import pipeline as tpar
from autopanostitch_tpu_torch.parallel import sharded as tsh
from autopanostitch_tpu_torch.utils import image_io as tio
from autopanostitch_tpu_torch.utils import real_data as treal

WORLDS = (1, 2, 3)
SEED_VERIFY = 5  # the RANSAC generator's seed in the verify cases
RANKS_TIMEOUT_S = 900  # the ranks' whole run; a collective waits at most 300 s

# ---- the scenes: numpy inputs from seeds, the same for both packages ----


def _extract_images(n):
    return np.stack([synthdata.texture(s, 128, 128).mean(-1) for s in range(n)]).astype(np.float32)


def _knn_inputs():
    """tests/test_parallel.py's pool (200 unit vectors of 32, 4 images),
    with ~10 % invalid rows."""
    r = np.random.default_rng(0)
    desc = r.normal(size=(200, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    ids = np.repeat(np.arange(4), 50).astype(np.int32)
    mask = np.random.default_rng(9).random(200) > 0.1
    return desc, mask, ids


def _verify_inputs():
    r = np.random.default_rng(1)
    P_, M = 6, 64
    src = np.zeros((P_, M, 2), np.float32)
    dst = np.zeros((P_, M, 2), np.float32)
    mask = np.zeros((P_, M), bool)
    for p in range(P_):
        pts = r.uniform(0, 300, size=(48, 2)).astype(np.float32)
        t = r.uniform(-50, 50, size=2).astype(np.float32)
        src[p, :48] = pts
        dst[p, :48] = pts + t
        dst[p, 40:48] = r.uniform(0, 300, size=(8, 2))  # outliers
        mask[p, :48] = True
    return src, dst, mask


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _cameras(n_img, step, first, seed0):
    imgs = np.stack([synthdata.texture(seed0 + s, 96, 128) for s in range(n_img)]).astype(np.float32)
    sizes = np.tile(np.array([96, 128], np.int32), (n_img, 1))
    feathers = tsamp.feather_stack(torch.as_tensor(sizes), 96, 128).numpy()
    R = np.stack([_yaw(step * k + first) for k in range(n_img)])
    K = np.tile(np.array([[120.0, 0, 63.5], [0, 120.0, 47.5], [0, 0, 1]], np.float32), (n_img, 1, 1))
    return imgs, feathers, sizes, R, K


def _psum_inputs(world):
    """Each rank's partial (1, 4, 4) counts and (1, 4, 4, 3) colour sums:
    halves of integers, so any order of the sum over ranks is exact."""
    r = np.random.default_rng(world)
    return (r.integers(0, 50, (world, 1, 4, 4)).astype(np.float32),
            r.integers(0, 2 * 255 * 50, (world, 1, 4, 4, 3)).astype(np.float32) / 2)


def _cfg(config, fields):
    base = config.StitchConfig()
    return base.replace(**{sec: dataclasses.replace(getattr(base, sec), **f)
                           for sec, f in fields.items()})


RING_CFG = {"detector": {"max_keypoints": 384, "num_octaves": 3},
            "matching": {"max_matches_per_pair": 256, "second_pass": False},
            "image_match": {"ransac_batch": 256},
            "bundle": {"incremental_lm_iters": 6, "max_iter_lm": 18},
            "straighten": {"enabled": False},
            "render": {"projections": ("spherical",)}, "blend": {"mode": "linear"}}
MULTI_CFG = {"detector": {"max_keypoints": 384, "num_octaves": 3},
             "matching": {"max_matches_per_pair": 256},
             "image_match": {"ransac_batch": 256},
             "bundle": {"incremental_lm_iters": 6, "max_iter_lm": 15},
             "straighten": {"force_planar_scan": True}}


def _ring_set(image_set_cls):
    _, views, _, _ = synthdata.rotational_views(17, n_views=4, f=320.0, size=(320, 256),
                                                yaw_step=0.5)
    sizes = np.array([v.shape[:2] for v in views], np.int32)
    return image_set_cls(images=(np.stack(views) * 255).astype(np.uint8), sizes=sizes,
                         names=[f"v{k}" for k in range(len(views))])


def _multi_set(image_set_cls):
    env_a = synthdata.texture(71, 400, 700)
    env_b = synthdata.texture(72, 400, 700)
    va = synthdata.planar_crops(env_a, [(0, 0, 400, 340), (260, 20, 400, 340)])
    vb = synthdata.planar_crops(env_b, [(20, 10, 400, 340), (280, 0, 400, 340)])
    views = [va[0], vb[0], va[1], vb[1]]
    sizes = np.array([v.shape[:2] for v in views], np.int32)
    return image_set_cls(images=(np.stack(views) * 255).astype(np.uint8), sizes=sizes,
                         names=[f"v{k}" for k in range(4)])


def _members(res):
    return sorted(tuple(sorted(np.asarray(p["members"]).tolist())) for p in res.panoramas)


def _stitch_record(res, prefix):
    p = res.panoramas[0]
    g = res.graph
    return {f"{prefix}_pairs": g.pairs, f"{prefix}_accepted": g.accepted, f"{prefix}_H": g.H,
            f"{prefix}_inliers": g.inliers, f"{prefix}_num_inliers": g.num_inliers,
            f"{prefix}_f": p["ba"]["cameras"].f.numpy(),
            f"{prefix}_pano": p["projections"]["spherical"]}


# ---- the ranks ----


def rank_main(index, plan, tmpdir):
    """Rank `plan[index]` = (world, rank): every case of its world size, its
    outputs to tmpdir/w{world}_r{rank}.npz."""
    world, rank = plan[index]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = tmesh.make_mesh("cpu")
    out = {"rank": np.int64(mesh.rank), "size": np.int64(mesh.size)}
    try:
        tmesh.make_mesh("cpu", backend="nccl")
    except ValueError:
        out["nccl_on_cpu_refused"] = np.bool_(True)
    out["replicated"] = tmesh.replicate(torch.full((3,), float(rank) + 1.0), mesh).numpy()
    out["shard"] = tmesh.shard_leading(torch.arange(7), mesh, value=-1).numpy()
    ring = tpar.stitch_multichip(_ring_set(tio.ImageSet), _cfg(tconfig, RING_CFG), mesh=mesh,
                                 seed=0)
    out.update(_stitch_record(ring, "ring"))
    if world > 1:
        n_img = 8 if world == 2 else 4
        f = tsh.sharded_extract(_extract_images(n_img), mesh,
                                tconfig.DetectorConfig(max_keypoints=128, num_octaves=2))
        out.update(extract_xy=f.xy.numpy(), extract_mask=f.mask.numpy(),
                   extract_desc=f.desc.numpy())
        desc, mask, ids = _knn_inputs()
        for name, m in (("all", np.ones_like(mask)), ("masked", mask)):
            idx, d = tsh.sharded_global_knn(desc, m, ids, mesh, k=3)
            out[f"knn_{name}_idx"], out[f"knn_{name}_dist"] = idx.numpy(), d.numpy()
        src, dst, vmask = _verify_inputs()
        g = torch.Generator().manual_seed(SEED_VERIFY)
        ver = tsh.sharded_verify_pairs(src, dst, vmask, g, mesh, threshold=2.0, batch=128)
        out.update({f"verify_{k}": v for k, v in ver.items()})
        ov, cs = _psum_inputs(world)
        s_ov, s_cs = tsh.psum_gain_stats(ov[rank], cs[rank], mesh)
        out.update(psum_overlap=s_ov.numpy(), psum_colors=s_cs.numpy())
        imgs, fea, sizes, R, K = _cameras(3, 0.3, -0.3, 0)
        canvas = trender.compute_canvas(R, K, sizes, "spherical")
        pano, cov = tsh.sharded_render_bands(imgs, fea, R, K, np.ones((3, 3), np.float32), canvas,
                                             mesh, blend_mode="linear")
        out.update(bands_pano=pano[: canvas["Hc"]], bands_cov=cov[: canvas["Hc"]])
        imgs, fea, sizes, R, K = _cameras(5, 0.35, -0.7, 0)
        canvas = trender.compute_canvas(R, K, sizes, "spherical")
        pano, cov = tsh.sharded_render_tiles(
            torch.as_tensor(imgs), torch.as_tensor(fea), R, K, canvas, mesh, **_tiles_kw(sizes))
        out.update(tiles_pano=pano, tiles_cov=cov)
        imgs, fea, sizes, R, K = _cameras(4, 0.3, -0.45, 10)
        Nij, sumC = tsh.sharded_gain_stats_imagespace(imgs, fea, sizes, R, K, mesh, stride=5)
        out.update(gain_Nij=Nij.numpy(), gain_sumC=sumC.numpy())
    if world == 2:
        multi = tpar.stitch_multichip(_multi_set(tio.ImageSet), _cfg(tconfig, MULTI_CFG), mesh=mesh)
        out["multi_members"] = np.array(_members(multi))
        try:
            tpar.stitch_multichip(_multi_set(tio.ImageSet),
                                 _cfg(tconfig, {"detector": {"detector": "ORB"}}), mesh=mesh)
        except ValueError as e:
            out["orb_refused"] = np.bool_("SIFT" in str(e))
        step = tsh.multichip_pipeline_step(mesh, tconfig.DetectorConfig(max_keypoints=128,
                                                                        num_octaves=2))
        src, dst, vmask = _verify_inputs()
        ov, cs = _psum_inputs(world)
        res = step(_extract_images(4), src, dst, vmask, torch.Generator().manual_seed(SEED_VERIFY),
                   ov[rank], cs[rank])
        out.update({f"step_{k}": np.asarray(v) for k, v in res.items()})
    np.savez(f"{tmpdir}/w{world}_r{rank}.npz", **out)
    dist.destroy_process_group()


def _tiles_kw(sizes):
    gains = np.linspace(0.8, 1.2, 15).reshape(5, 3).astype(np.float32)
    return dict(gains=gains, blend_mode="multiband", bands=3, tile=(64, 128), sizes=sizes,
                interp="bicubic")


# ---- the reference side, computed while the ranks run ----


def _jax_side():
    import jax.numpy as jnp

    from autopanostitch_tpu import config as jconfig
    from autopanostitch_tpu.models import render as jrender
    from autopanostitch_tpu.parallel import mesh as jmesh
    from autopanostitch_tpu.parallel import pipeline as jmp
    from autopanostitch_tpu.parallel import sharded as jsh
    from autopanostitch_tpu.utils.image_io import ImageSet as JImageSet

    m8 = jmesh.make_mesh(8)
    out = {}
    f = jsh.sharded_extract(jnp.asarray(_extract_images(8)), m8,
                            jconfig.DetectorConfig(max_keypoints=128, num_octaves=2))
    out["extract_xy"], out["extract_mask"] = np.asarray(f.xy), np.asarray(f.mask)
    desc, mask, ids = _knn_inputs()
    for name, m in (("all", np.ones_like(mask)), ("masked", mask)):
        idx, d = jsh.sharded_global_knn(jnp.asarray(desc), jnp.asarray(m), jnp.asarray(ids), m8,
                                        k=3)
        out[f"knn_{name}_idx"], out[f"knn_{name}_dist"] = np.asarray(idx), np.asarray(d)
    for w in WORLDS[1:]:
        ov, cs = _psum_inputs(w)
        s_ov, s_cs = jsh.psum_gain_stats(jnp.asarray(ov.reshape(w, 4, 4)),
                                         jnp.asarray(cs.reshape(w, 4, 4, 3)), jmesh.make_mesh(w))
        out[f"psum_overlap_{w}"], out[f"psum_colors_{w}"] = np.asarray(s_ov), np.asarray(s_cs)
    imgs, fea, sizes, R, K = _cameras(3, 0.3, -0.3, 0)
    canvas = jrender.compute_canvas(R, K, sizes, "spherical")
    pano, cov = jsh.sharded_render_bands(imgs, fea, R, K, np.ones((3, 3), np.float32), canvas, m8,
                                         blend_mode="linear")
    out["bands_pano"], out["bands_cov"] = (np.asarray(pano)[: canvas["Hc"]],
                                           np.asarray(cov)[: canvas["Hc"]])
    imgs, fea, sizes, R, K = _cameras(5, 0.35, -0.7, 0)
    canvas = jrender.compute_canvas(R, K, sizes, "spherical")
    out["tiles_pano"], out["tiles_cov"] = jsh.sharded_render_tiles(imgs, fea, R, K, canvas, m8,
                                                                   **_tiles_kw(sizes))
    imgs, fea, sizes, R, K = _cameras(4, 0.3, -0.45, 10)
    Nij, sumC = jsh.sharded_gain_stats_imagespace(imgs, fea, sizes, R, K, m8, stride=5)
    out["gain_Nij"], out["gain_sumC"] = np.asarray(Nij), np.asarray(sumC)
    ring = jmp.stitch_multichip(_ring_set(JImageSet), _cfg(jconfig, RING_CFG), mesh=m8, seed=0)
    p = ring.panoramas[0]
    out.update(ring_pairs=ring.graph.pairs, ring_accepted=np.asarray(ring.graph.accepted),
               ring_H=np.asarray(ring.graph.H), ring_f=np.asarray(p["ba"]["cameras"].f),
               ring_pano=p["projections"]["spherical"])
    multi = jmp.stitch_multichip(_multi_set(JImageSet), _cfg(jconfig, MULTI_CFG), mesh=m8)
    out["multi_members"] = np.array(_members(multi))
    return out


def _port_single():
    """The port's single-device results on the same inputs."""
    out = {}
    desc, mask, ids = _knn_inputs()
    for name, m in (("all", np.ones_like(mask)), ("masked", mask)):
        idx, d = tmt.global_knn(torch.as_tensor(desc), torch.as_tensor(m), torch.as_tensor(ids),
                                k=3)
        out[f"knn_{name}_idx"], out[f"knn_{name}_dist"] = idx.numpy(), d.numpy()
    src, dst, vmask = _verify_inputs()
    kw = dict(threshold=2.0, batch=128)
    ver = trs.verify_pairs(src, dst, vmask, generator=torch.Generator().manual_seed(SEED_VERIFY),
                           **kw)
    sets = trs.draw_minimal_sets(vmask, batch=128,
                                 generator=torch.Generator().manual_seed(SEED_VERIFY))
    ver_sets = trs.verify_pairs(src, dst, vmask, minimal_sets=sets, **kw)
    out.update({f"verify_{k}": v for k, v in ver.items()})
    out.update({f"verify_sets_{k}": v for k, v in ver_sets.items()})
    imgs, fea, sizes, R, K = _cameras(5, 0.35, -0.7, 0)
    canvas = trender.compute_canvas(R, K, sizes, "spherical")
    out["tiles_pano"], out["tiles_cov"] = trender.render_rotational(
        torch.as_tensor(imgs), torch.as_tensor(fea), R, K, canvas, **_tiles_kw(sizes))
    ring = tpipe.stitch(_ring_set(tio.ImageSet), _cfg(tconfig, RING_CFG), seed=0, device="cpu")
    out.update(_stitch_record(ring, "ring"))
    cfg_d = tconfig.DetectorConfig(max_keypoints=128, num_octaves=2)
    f8 = tsift.extract_batch(torch.as_tensor(_extract_images(8)), cfg_d)
    out.update(extract_xy=f8.xy.numpy(), extract_mask=f8.mask.numpy(), extract_desc=f8.desc.numpy())
    f = tsift.extract_batch(torch.as_tensor(_extract_images(4)), cfg_d)
    N, Kk, D = f.desc.shape
    ids4 = torch.arange(N, dtype=torch.int32).repeat_interleave(Kk)
    idx, d = tmt.global_knn(f.desc.reshape(N * Kk, D), f.mask.reshape(N * Kk), ids4, k=2)
    step_ver = trs.verify_pairs(src, dst, vmask,
                                generator=torch.Generator().manual_seed(SEED_VERIFY))
    out.update(step_nn_idx=idx.numpy(), step_nn_dist=d.numpy(),
               step_n_keypoints=np.asarray(int(f.mask.sum())), step_H=step_ver["H"],
               step_accepted=step_ver["accepted"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn every rank of world sizes 1, 2 and 3 at once; compute the JAX
    package's and the port's single-device results meanwhile. Returns
    (rank outputs {world: [npz per rank]}, jax outputs, port outputs)."""
    tmp = tmp_path_factory.mktemp("ranks")
    plan = [(w, r) for w in WORLDS for r in range(w)]
    ctx = mp.spawn(rank_main, args=(plan, str(tmp)), nprocs=len(plan), join=False)
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        jax_out = _jax_side()
        port_out = _port_single()
    finally:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"the ranks ran beyond {RANKS_TIMEOUT_S} s")
    outs = {w: [dict(np.load(tmp / f"w{w}_r{r}.npz")) for r in range(w)] for w in WORLDS}
    return outs, jax_out, port_out


SHARDED = [2, 3]


def test_mesh_records_the_group(ranks):
    outs, _, _ = ranks
    for w in WORLDS:
        for r, o in enumerate(outs[w]):
            assert int(o["rank"]) == r and int(o["size"]) == w
            assert bool(o["nccl_on_cpu_refused"])
            np.testing.assert_array_equal(o["replicated"], np.ones(3))
            per = -(-7 // w)
            want = np.full(per, -1)
            real = np.arange(7)[r * per : (r + 1) * per]
            want[: len(real)] = real
            np.testing.assert_array_equal(o["shard"], want)


def test_make_mesh_needs_a_process_group(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        pytest.skip("a process group is initialised in this process")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmesh.make_mesh("cuda")


@pytest.mark.parametrize("world", SHARDED)
def test_sharded_extract_matches_jax(ranks, world):
    """Every feature equal to the port's single-device `extract_batch`;
    against the JAX package the same mask, and keypoints within the port's
    SIFT parity tolerance (tests/test_torch_sift.py: 0.01 px; XLA's and
    PyTorch's float32 pyramids differ by ~1e-5, which the sub-pixel
    refinement can move by ~1e-3 px)."""
    outs, jax_out, port = ranks
    n = 8 if world == 2 else 4
    for o in outs[world]:
        for k in ("xy", "mask", "desc"):
            np.testing.assert_array_equal(o[f"extract_{k}"], port[f"extract_{k}"][:n])
        np.testing.assert_array_equal(o["extract_mask"], jax_out["extract_mask"][:n])
        np.testing.assert_allclose(o["extract_xy"], jax_out["extract_xy"][:n], atol=1e-2)


@pytest.mark.parametrize("world", SHARDED)
@pytest.mark.parametrize("rows", ["all", "masked"])
def test_sharded_knn_matches_jax_and_single(ranks, world, rows):
    """Against the JAX package: indices equal, distances within 1e-4 on the
    valid rows. Against the port's single-device `global_knn`: the same
    arrays on every row (invalid and padded queries included), so the same
    ratio decisions and kNN votes."""
    outs, jax_out, port = ranks
    _, mask, ids = _knn_inputs()
    valid = np.ones_like(mask) if rows == "all" else mask
    for o in outs[world]:
        idx, d = o[f"knn_{rows}_idx"], o[f"knn_{rows}_dist"]
        np.testing.assert_array_equal(idx[valid], jax_out[f"knn_{rows}_idx"][valid])
        np.testing.assert_allclose(d[valid], jax_out[f"knn_{rows}_dist"][valid], atol=1e-4)
        np.testing.assert_array_equal(idx, port[f"knn_{rows}_idx"])
        np.testing.assert_array_equal(d, port[f"knn_{rows}_dist"])
        best, acc = tmt.global_ratio_test(torch.as_tensor(idx), torch.as_tensor(d))
        best_p, acc_p = tmt.global_ratio_test(torch.as_tensor(port[f"knn_{rows}_idx"]),
                                              torch.as_tensor(port[f"knn_{rows}_dist"]))
        assert torch.equal(acc, acc_p) and torch.equal(best, best_p)
        np.testing.assert_array_equal(tmt.knn_votes(idx, d, ids, 4),
                                      tmt.knn_votes(port[f"knn_{rows}_idx"],
                                                    port[f"knn_{rows}_dist"], ids, 4))


@pytest.mark.parametrize("world", SHARDED)
def test_sharded_verify_pairs(ranks, world):
    """tests/test_parallel.py's asserts; and exactly the port's
    `verify_pairs` with the same generator, and with the same minimal sets
    given explicitly."""
    outs, _, port = ranks
    for o in outs[world]:
        assert o["verify_accepted"].all()
        assert (o["verify_num_inliers"] >= 38).all()
        for k in ("H", "H_inv", "inliers", "num_inliers", "num_putative", "accepted"):
            np.testing.assert_array_equal(o[f"verify_{k}"], port[f"verify_{k}"])
            np.testing.assert_array_equal(o[f"verify_{k}"], port[f"verify_sets_{k}"])


@pytest.mark.parametrize("world", SHARDED)
def test_psum_gain_stats_matches_jax(ranks, world):
    outs, jax_out, _ = ranks
    for o in outs[world]:
        np.testing.assert_array_equal(o["psum_overlap"], jax_out[f"psum_overlap_{world}"])
        np.testing.assert_array_equal(o["psum_colors"], jax_out[f"psum_colors_{world}"])


@pytest.mark.parametrize("world", SHARDED)
@pytest.mark.parametrize("kind", ["bands", "tiles"])
def test_sharded_render_matches_jax(ranks, world, kind):
    """Coverage equal and |diff| <= 1 uint8 against the JAX package's sharded
    render; the tiles also bit-equal to the port's `render_rotational`."""
    outs, jax_out, port = ranks
    for o in outs[world]:
        pano, cov = o[f"{kind}_pano"], o[f"{kind}_cov"]
        assert pano.shape == jax_out[f"{kind}_pano"].shape
        np.testing.assert_array_equal(cov, jax_out[f"{kind}_cov"])
        assert np.abs(pano.astype(int) - jax_out[f"{kind}_pano"].astype(int)).max() <= 1
        if kind == "tiles":
            np.testing.assert_array_equal(pano, port["tiles_pano"])
            np.testing.assert_array_equal(cov, port["tiles_cov"])


@pytest.mark.parametrize("world", SHARDED)
def test_sharded_gain_stats_matches_jax(ranks, world):
    outs, jax_out, _ = ranks
    for o in outs[world]:
        np.testing.assert_allclose(o["gain_Nij"], jax_out["gain_Nij"], atol=1e-6)
        np.testing.assert_allclose(o["gain_sumC"], jax_out["gain_sumC"], rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("against", ["jax_multichip", "port_stitch"])
def test_stitch_multichip_matches(ranks, world, against):
    """tests/test_parallel.py's end-to-end comparison: the same pairs and
    accepted pairs, H within 1e-4, f within 5e-4 relative, the panorama
    within 1 uint8 LSB on average; against the JAX package's
    stitch_multichip on 8 devices and the port's single-device stitch."""
    outs, jax_out, port = ranks
    ref = jax_out if against == "jax_multichip" else port
    for o in outs[world]:
        np.testing.assert_array_equal(o["ring_pairs"], ref["ring_pairs"])
        np.testing.assert_array_equal(o["ring_accepted"], ref["ring_accepted"])
        np.testing.assert_allclose(o["ring_H"], ref["ring_H"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["ring_f"], ref["ring_f"], rtol=5e-4)
        a, b = o["ring_pano"].astype(np.int16), ref["ring_pano"].astype(np.int16)
        assert a.shape == b.shape
        assert np.mean(np.abs(a - b)) < 1.0


def test_world_sizes_give_identical_graphs(ranks):
    outs, _, _ = ranks
    keys = ("pairs", "accepted", "H", "inliers", "num_inliers")
    for w in WORLDS[1:]:
        for k in keys:
            np.testing.assert_array_equal(outs[w][0][f"ring_{k}"], outs[1][0][f"ring_{k}"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(ranks, world):
    outs, _, _ = ranks
    skip = {"rank", "shard"}
    for o in outs[world][1:]:
        assert set(o) == set(outs[world][0])
        for k in set(o) - skip:
            np.testing.assert_array_equal(o[k], outs[world][0][k], err_msg=k)


def test_stitch_multichip_multi_panorama_second_pass(ranks):
    outs, jax_out, _ = ranks
    for o in outs[2]:
        assert o["multi_members"].tolist() == jax_out["multi_members"].tolist() == [[0, 2], [1, 3]]
        assert bool(o["orb_refused"])


def test_multichip_pipeline_step(ranks):
    """The step's kNN, keypoint count and RANSAC are the port's
    single-device ones, its statistics the sums over ranks (the JAX
    package's psum)."""
    outs, jax_out, port = ranks
    for o in outs[2]:
        np.testing.assert_array_equal(o["step_nn_idx"], port["step_nn_idx"])
        np.testing.assert_array_equal(o["step_nn_dist"], port["step_nn_dist"])
        assert int(o["step_n_keypoints"]) == int(port["step_n_keypoints"])
        np.testing.assert_array_equal(o["step_H"], port["step_H"])
        np.testing.assert_array_equal(o["step_accepted"], port["step_accepted"])
        np.testing.assert_array_equal(o["step_gain_overlap"], jax_out["psum_overlap_2"])
        np.testing.assert_array_equal(o["step_gain_colors"], jax_out["psum_colors_2"])


# ---- the host utilities ----


def test_perturb_matches_jax():
    from autopanostitch_tpu.utils import perturb as jp
    from autopanostitch_tpu_torch.utils import perturb as tp

    views = [synthdata.texture(s, 48, 64) for s in range(3)]
    for a, b in zip(tp.perturb_views(views, seed=3), jp.perturb_views(views, seed=3)):
        np.testing.assert_array_equal(a, b)
    img = views[0]
    np.testing.assert_array_equal(tp.exposure_jitter(img, -0.7), jp.exposure_jitter(img, -0.7))
    np.testing.assert_array_equal(tp.radial_distort(img, 0.08, -0.02),
                                  jp.radial_distort(img, 0.08, -0.02))
    np.testing.assert_array_equal(tp.add_sensor_noise(img, 0.01, np.random.default_rng(1)),
                                  jp.add_sensor_noise(img, 0.01, np.random.default_rng(1)))


def test_real_data_matches_jax(tmp_path):
    """Montage slicing (blank slots trimmed) and `image_set_from_arrays` on
    a synthetic 3 x 5 sheet, against the JAX package's functions."""
    from PIL import Image

    jr, tr = jreal, treal
    assert tr.MONTAGES == jr.MONTAGES and tr.REFERENCE_ASSETS == jr.REFERENCE_ASSETS
    rows, cols = tr.MONTAGES["ucsb4"]
    sheet = np.full((rows * 60, cols * 80, 3), 255, np.uint8)
    for k in range(12):  # 12 photographs, 3 blank slots
        r, c = divmod(k, cols)
        sheet[r * 60 : (r + 1) * 60, c * 80 : (c + 1) * 80] = (
            synthdata.texture(40 + k, 60, 80) * 200).astype(np.uint8)
    Image.fromarray(sheet).save(tmp_path / "dataset_samples_ucsb4.png")
    Image.fromarray(sheet).save(tmp_path / "dataset_samples_CMU0.png")
    assert tr.have_reference_assets(str(tmp_path)) and jr.have_reference_assets(str(tmp_path))
    a = tr.load_montage_tiles("ucsb4", str(tmp_path))
    b = jr.load_montage_tiles("ucsb4", str(tmp_path))
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tr.church_paths(str(tmp_path)) == jr.church_paths(str(tmp_path))
    sa, sb = tr.image_set_from_arrays(a, 50, 50), jr.image_set_from_arrays(b, 50, 50)
    np.testing.assert_array_equal(sa.images, sb.images)
    np.testing.assert_array_equal(sa.sizes, sb.sizes)


@pytest.mark.skipif(not jreal.have_reference_assets(), reason="reference assets not present")
def test_real_data_reference_sheets_match_jax():
    for name in treal.MONTAGES:
        for x, y in zip(treal.load_montage_tiles(name), jreal.load_montage_tiles(name)):
            np.testing.assert_array_equal(x, y)
