"""The reference's (B, H, W, C) surface in the port, held against the JAX
package: the NHWC losses (``masked_l1``, ``ssim``, ``photometric_loss``),
the NHWC warps (``ops.stereo_warp``, ``frozen_warp``, ``fused_warp``),
``geometry.intrinsics_matrix``, ``DepthNet.single_scale`` and the mesh
helpers (``num_processes``, ``shard_batch``, ``shard_stacked_batch``).

The reference's warps run with ``use_pallas=True`` under
``warp_pallas.INTERPRET`` (its kernel path, whose ``dmax=None`` is the
kernel's bound of 128; the jnp fallback leaves it unbounded), the port's
on the CPU, where each CUDA kernel is its plain version. The general
warps take the reference's sample coordinates as values (the two
``warp_coords`` agree to 2e-5 px, which tests/test_torch_geometry.py
holds; here the point is the sampler, its masks and its gradient). Bars:
losses 1e-5, warped values 1e-6 under ``valid`` (``valid`` identical),
the warps' VJPs 1e-5 absolute (the general warps' depth gradient: the
port's gradient at the coordinates, carried to depth by the reference's
coordinate chain), ``single_scale`` 2e-5 relative to its largest
magnitude.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from depthvo_tpu import configs as jconfigs
from depthvo_tpu import ops as jops
from depthvo_tpu.geometry import camera as jcam, se3 as jse3, warp as jwarp
from depthvo_tpu.losses import photometric as jphoto
from depthvo_tpu.ops import warp_pallas
from depthvo_tpu.parallel import mesh as jmesh
from depthvo_tpu.train.state import build_models as jbuild_models
from depthvo_tpu_torch import configs as tconfigs, ops as tops
from depthvo_tpu_torch.geometry import intrinsics_matrix, warp as twarp
from depthvo_tpu_torch.io.to_flax_layout import to_flax_layout
from depthvo_tpu_torch.losses import photometric as tphoto
from depthvo_tpu_torch.parallel import mesh as tmesh
from depthvo_tpu_torch.train.state import build_models, init_params, load_params

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FXB = 74.0 * 0.54
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def interpret_mode():
    warp_pallas.INTERPRET = True
    yield
    warp_pallas.INTERPRET = False


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, dtype=np.float32)).requires_grad_(grad)


def _masked(rng, shape, valid):
    """A cotangent that is zero outside ``valid``, as the losses make it."""
    return (rng.normal(size=shape) * np.asarray(valid)[..., None]).astype(np.float32)


def _match(got, valid, ref, ref_valid, atol=1e-6):
    ref_valid = np.asarray(ref_valid)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    assert ref_valid.mean() > 0.3, "too few valid pixels to compare"
    mask = np.broadcast_to(ref_valid[..., None], got.shape)
    assert np.abs(got.detach().numpy() - np.asarray(ref))[mask].max() <= atol


@pytest.mark.parametrize("ssim_weight", [0.0, 0.85])
def test_nhwc_losses_match_the_reference(rng, ssim_weight):
    B, H, W, C = 2, 12, 20, 3
    x = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    y = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.2
    got = tphoto.masked_l1(_t(x), _t(y), torch.from_numpy(mask))
    assert abs(float(got) - float(jphoto.masked_l1(x, y, mask))) <= 1e-5
    s = tphoto.ssim(_t(x), _t(y)).numpy()
    ref = np.asarray(jphoto.ssim(x, y))
    assert s.shape == ref.shape == (B, H - 2, W - 2, C)
    np.testing.assert_allclose(s, ref, rtol=0, atol=1e-5)
    got = tphoto.photometric_loss(_t(x), _t(y), torch.from_numpy(mask), ssim_weight)
    ref = jphoto.photometric_loss(x, y, mask, ssim_weight)
    assert abs(float(got) - float(ref)) <= 1e-5


@pytest.mark.parametrize("W,dmax", [(128, 24), (96, None)])
def test_nhwc_stereo_warp_and_its_vjp_match_the_kernel_path(rng, W, dmax):
    """The source and the depth both differentiated: on the card that is
    K1 forward, K2 and K3 backward."""
    B, H, C = 2, 16, 3
    src = rng.normal(size=(B, H, W, C)).astype(np.float32)
    depth = rng.uniform(4.0, 40.0, (B, H, W)).astype(np.float32)
    (ref, ref_valid), vjp = jax.vjp(
        lambda s, d: jops.stereo_warp(s, d, FXB, use_pallas=True, dmax=dmax), src, depth)
    g = _masked(rng, src.shape, ref_valid)
    ref_dsrc, ref_ddepth = vjp((g, np.zeros(ref_valid.shape, jax.dtypes.float0)))

    tsrc, tdepth = _t(src, True), _t(depth, True)
    got, valid = tops.stereo_warp(tsrc, tdepth, FXB, dmax=dmax)
    assert got.shape == src.shape
    _match(got, valid, ref, ref_valid)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(tsrc.grad.numpy(), np.asarray(ref_dsrc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdepth.grad.numpy(), np.asarray(ref_ddepth), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(ref_dsrc)).max() > 0.1 and np.abs(np.asarray(ref_ddepth)).max() > 0
    if dmax is None:  # the kernel's bound: a disparity of 133 px is invalid
        src, depth = src[:1, :4, :1].repeat(200, 2), np.full((1, 4, 200), FXB / 133, np.float32)
        _, unbounded = jops.stereo_warp(src, depth, FXB, use_pallas=False)
        _, bounded = tops.stereo_warp(_t(src), _t(depth), FXB)
        assert np.asarray(unbounded)[0, :3, 134:-1].all() and not bounded.numpy().any()


def _scene(rng, C, H, W, twist):
    src = rng.normal(size=(1, H, W, C)).astype(np.float32)
    depth = rng.uniform(4.0, 40.0, (1, H, W)).astype(np.float32)
    K = np.asarray(jcam.intrinsics_matrix(0.58 * W, 1.0 * H, W / 2, H / 2))[None]
    return src, depth, np.asarray(jse3.exp(np.asarray([twist], np.float32))), K


@pytest.fixture
def coords_leaf(monkeypatch):
    """The port's ``warp_coords`` giving the reference's values as a leaf
    tensor (appended to the returned list): its ``.grad`` is the port's
    sampler VJP, which the tests carry to depth through the reference's
    own ``warp_coords`` VJP (the geometry's gradient is
    tests/test_torch_geometry.py's)."""
    leaves = []

    def coords(depth, T, K):
        ref_c, ref_front = jwarp.warp_coords(depth.detach().numpy(), T.detach().numpy(),
                                             K.detach().numpy())
        leaves.append(_t(ref_c, True))
        return leaves[-1], torch.from_numpy(np.array(ref_front))

    monkeypatch.setattr(twarp, "warp_coords", coords)
    return leaves


def _depth_grad(leaves, depth, T, K):
    """The port's coordinate gradient carried to depth by the reference's
    ``warp_coords`` VJP."""
    (leaf,) = leaves
    _, vjp = jax.vjp(lambda d: jwarp.warp_coords(d, T, K)[0], depth)
    return np.asarray(vjp(leaf.grad.numpy())[0])


SMALL = [0.02, -0.01, -0.3, 0.002, -0.003, 0.001]


@pytest.mark.parametrize("C,H,W,pad_v", [(3, 24, 128, 8), (3, 16, 96, 16)])
def test_nhwc_frozen_warp_and_its_vjp_match_the_kernel_path(rng, coords_leaf, C, H, W, pad_v):
    """The depth differentiated, the source frozen (K4 forward, K5
    backward); (3, 16, 96, 16) is the branch where no window fits."""
    src, depth, T, K = _scene(rng, C, H, W, SMALL)
    (ref, ref_valid), vjp = jax.vjp(
        lambda d: jops.frozen_warp(src, d, T, K, use_pallas=True, pad_v=pad_v), depth)
    g = _masked(rng, src.shape, ref_valid)
    (ref_ddepth,) = vjp((g, np.zeros(ref_valid.shape, jax.dtypes.float0)))

    tsrc = _t(src, True)
    got, valid = tops.frozen_warp(tsrc, _t(depth), _t(T), _t(K), pad_v=pad_v)
    _match(got, valid, ref, ref_valid)
    (got * _t(g)).sum().backward()
    assert tsrc.grad is None
    np.testing.assert_allclose(_depth_grad(coords_leaf, depth, T, K), np.asarray(ref_ddepth),
                               rtol=0, atol=1e-5)
    assert np.abs(np.asarray(ref_ddepth)).max() > 1e-3


def test_nhwc_fused_warp_and_its_vjp_match_the_xla_path(rng, coords_leaf):
    src, depth, T, K = _scene(rng, 3, 24, 96, SMALL)
    (ref, ref_valid), vjp = jax.vjp(lambda s, d: jops.fused_warp(s, d, T, K), src, depth)
    g = _masked(rng, src.shape, ref_valid)
    ref_dsrc, ref_ddepth = vjp((g, np.zeros(ref_valid.shape, jax.dtypes.float0)))

    tsrc = _t(src, True)
    got, valid = tops.fused_warp(tsrc, _t(depth), _t(T), _t(K), use_pallas=True)
    _match(got, valid, ref, ref_valid)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(tsrc.grad.numpy(), np.asarray(ref_dsrc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_depth_grad(coords_leaf, depth, T, K), np.asarray(ref_ddepth),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("op", ["stereo_warp", "frozen_warp"])
def test_use_pallas_true_on_a_cpu_tensor_raises(rng, op):
    src, depth, T, K = _scene(rng, 3, 16, 32, SMALL)
    args = (_t(depth), FXB) if op == "stereo_warp" else (_t(depth), _t(T), _t(K))
    with pytest.raises(ValueError, match="use_pallas=True"):
        getattr(tops, op)(_t(src), *args, use_pallas=True)
    plain, _ = getattr(tops, op)(_t(src), *args, use_pallas=False)
    default, _ = getattr(tops, op)(_t(src), *args)
    assert torch.equal(plain, default)


def test_intrinsics_matrix_equals_the_reference():
    np.testing.assert_array_equal(intrinsics_matrix(350.0, 340.0, 300.5, 80.25).numpy(),
                                  np.asarray(jcam.intrinsics_matrix(350.0, 340.0, 300.5, 80.25)))
    fx = np.asarray([100.0, 200.0], np.float32)
    np.testing.assert_array_equal(intrinsics_matrix(torch.from_numpy(fx), 2.0, 3.0, 4.0).numpy(),
                                  np.asarray(jcam.intrinsics_matrix(fx, 2.0, 3.0, 4.0)))


def test_single_scale_matches_the_reference(rng):
    cfg = tconfigs.tiny_test()
    models = load_params(build_models(cfg), init_params(cfg, torch.Generator().manual_seed(3)),
                         CPU)
    for name, buf in models.depth.named_buffers():
        if name.endswith("running_var"):
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
        elif name.endswith("running_mean"):
            buf.copy_(torch.from_numpy(0.1 * rng.normal(size=buf.shape).astype(np.float32)))
    params, stats = to_flax_layout(models)
    x = rng.uniform(-1, 1, (2, cfg.model.height, cfg.model.width, 3)).astype(np.float32)
    dn, _, _ = jbuild_models(jconfigs.tiny_test())
    ref = np.asarray(dn.apply({"params": params["depth"], "batch_stats": stats}, x, False,
                              method=dn.single_scale))
    with torch.no_grad():
        got = models.depth.eval().single_scale(_t(x)).numpy()
    assert got.shape == ref.shape == (2, cfg.model.height, cfg.model.width, 1)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 2e-5


def _global_batch(rng):
    return {"image_t": rng.integers(0, 255, (4, 6, 8, 3), dtype=np.uint8),
            "K": rng.normal(size=(4, 3, 3)).astype(np.float32),
            "baseline": np.float32(0.54)}


def _stacked_batch(rng):
    return {"image_t": rng.integers(0, 255, (3, 4, 6, 8, 3), dtype=np.uint8),
            "K": rng.normal(size=(3, 4, 3, 3)).astype(np.float32),
            "lr": np.arange(3, dtype=np.float32)}


def _reference_rows(arrays, n):
    """Per device of an n-device mesh, its rows of each leaf."""
    mesh = jmesh.make_mesh(n)
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    rows = [{} for _ in range(n)]
    for k, arr in arrays.items():
        for shard in arr.addressable_shards:
            rows[order[shard.device]][k] = np.asarray(shard.data)
    return rows


def test_shard_batch_on_a_mesh_of_one(rng):
    mesh = tmesh.make_mesh(device="cpu")
    assert tmesh.num_processes(mesh) == jmesh.num_processes(jmesh.make_mesh(1)) == 1
    for batch, port, ref in ((_global_batch(rng), tmesh.shard_batch, jmesh.shard_batch),
                             (_stacked_batch(rng), tmesh.shard_stacked_batch,
                              jmesh.shard_stacked_batch)):
        got = port(batch, mesh)
        (want,) = _reference_rows(ref(batch, jmesh.make_mesh(1)), 1)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].device == CPU
            np.testing.assert_array_equal(got[k].numpy(), want[k])


_RANKS = textwrap.dedent('''
    import sys
    import numpy as np
    from depthvo_tpu_torch.parallel import distributed as pdist, mesh as pmesh

    def rank(device, outdir):
        mesh = pmesh.make_mesh(device="cpu")
        for name, fn in (("flat", pmesh.shard_batch), ("stacked", pmesh.shard_stacked_batch)):
            batch = dict(np.load(f"{outdir}/{name}.npz"))
            got = fn(batch, mesh)
            np.savez(f"{outdir}/{name}_{mesh.rank}.npz",
                     **{k: v.numpy() for k, v in got.items()},
                     num_processes=pmesh.num_processes(mesh), device=str(got["K"].device))

    if __name__ == "__main__":
        pdist.spawn(rank, 2, 2, f"tcp://127.0.0.1:{pdist.free_port()}", "cpu",
                    args=(sys.argv[1],))
''')


def test_shard_batch_over_two_gloo_ranks_gives_each_the_reference_rows(rng, tmp_path):
    batches = {"flat": _global_batch(rng), "stacked": _stacked_batch(rng)}
    for name, b in batches.items():
        np.savez(tmp_path / f"{name}.npz", **b)
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=_REPO)
    r = subprocess.run([sys.executable, str(script), str(tmp_path)], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    for name, ref in (("flat", jmesh.shard_batch), ("stacked", jmesh.shard_stacked_batch)):
        want = _reference_rows(ref(batches[name], jmesh.make_mesh(2)), 2)
        for i in range(2):
            got = dict(np.load(tmp_path / f"{name}_{i}.npz"))
            assert int(got.pop("num_processes")) == 2 and str(got.pop("device")) == "cpu"
            assert got.keys() == want[i].keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[i][k])
    # The rows really were cut: rank 0 holds the first half of the batch.
    assert dict(np.load(tmp_path / "flat_0.npz"))["image_t"].shape[0] == 2
    assert dict(np.load(tmp_path / "stacked_1.npz"))["image_t"].shape[:2] == (3, 2)
