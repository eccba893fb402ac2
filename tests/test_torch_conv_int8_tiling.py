"""The tiling of kernel K8's conv (``ops/conv_int8.py::Int8ConvPlan``), walked
on the CPU: output boxes and their origins, the staged halo planes, the tap
-> row offsets, padded Cin and Cout, the cluster pairing of boxes and the
persistent walk of the tiles. The CUDA kernel cannot run here, so
:func:`walk` repeats what it does with the plan's numbers, in int64: each
cluster takes tiles ``cluster, cluster + n_clusters, ...``; each block of
the cluster stages, for each chunk of 64 input channels, the three dz planes
of its halo (zeros outside the volume, as TMA fills them), multiplies the 64
rows of each tap by the weight tile of that (tap, chunk) and writes the
voxels of its box that lie inside the volume. Its sums must equal the plain
version's and the JAX package's int32 conv exactly (integer sums), and every
output must be written exactly once.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops import conv_int8 as ci

CU = Path(ci.__file__).resolve().parents[1] / "csrc" / "conv_int8.cu"


def _stage(xq, origin, chunk):
    """A dz plane of the halo: ``HALO`` voxels from ``origin (b, x, y, z)``,
    channels ``64 chunk ..``, as ``(rows (x, y, z) row-major, 64)``, zeros
    outside ``xq (B, X, Y, Z, Cp)``."""
    b, x, y, z = origin
    hx, hy, hz = ci.HALO
    plane = torch.zeros((hx, hy, hz, 64), dtype=torch.int64)
    B, X, Y, Z, _ = xq.shape
    if 0 <= b < B:
        xs = [i for i in range(hx) if 0 <= x + i < X]
        ys = [i for i in range(hy) if 0 <= y + i < Y]
        zs = [i for i in range(hz) if 0 <= z + i < Z]
        if xs and ys and zs:
            plane[xs[0]:xs[-1] + 1, ys[0]:ys[-1] + 1, zs[0]:zs[-1] + 1] = xq[
                b, x + xs[0]:x + xs[-1] + 1, y + ys[0]:y + ys[-1] + 1, z + zs[0]:z + zs[-1] + 1,
                64 * chunk:64 * chunk + 64]
    return plane.reshape(-1, 64)


def walk(xq, wmat, plan, n_clusters):
    """The kernel's sums, computed the way it computes them: ``xq (B, X, Y,
    Z, Cp)`` int8 and ``wmat (cout_pad, 27 Cp)`` from ``gemm_int8_weights``.
    Returns ``(sums (B, X, Y, Z, Cout) int64, writes per output)``."""
    xq, wmat = xq.long(), wmat.long()
    out = torch.zeros((plan.B, plan.X, plan.Y, plan.Z, plan.cout), dtype=torch.int64)
    writes = torch.zeros_like(out)
    for cluster in range(n_clusters):
        for t in range(cluster, plan.n_tiles, n_clusters):
            for rank in range(ci.CLUSTER):
                box, n0 = plan.tile(t, rank)
                acc = torch.zeros((ci.BOX[0], 64, 256), dtype=torch.int64)
                for c in range(plan.chunks):
                    planes = [_stage(xq, plan.halo_origin(box, dz), c) for dz in (-1, 0, 1)]
                    for tap in range(27):
                        dx, dy, dz = tap // 9 - 1, tap // 3 % 3 - 1, tap % 3 - 1
                        k0 = plan.weight_col(tap, c)
                        w = wmat[n0:n0 + 256, k0:k0 + 64]
                        for xo in range(ci.BOX[0]):
                            r0 = plan.tap_row(xo, dx, dy)
                            acc[xo] += planes[dz + 1][r0:r0 + 64] @ w.T
                b, x0, y0, z0 = plan.box_origin(box)
                n1 = min(n0 + 256, plan.cout)
                for xo in range(ci.BOX[0]):
                    for r in range(64):
                        x, y, z = x0 + xo, y0 + r // 16, z0 + r % 16
                        if b < plan.B and x < plan.X and y < plan.Y and z < plan.Z:
                            out[b, x, y, z, n0:n1] = acc[xo, r, :n1 - n0]
                            writes[b, x, y, z, n0:n1] += 1
    return out, writes


def _operands(shape, cin, cout, seed):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (*shape, cin)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, 3, 3, 3)).astype(np.int8))
    return xq, wq


def _kernel_inputs(xq, wq, plan):
    xp = torch.nn.functional.pad(xq, (0, plan.cp - plan.cin))
    return xp, ci.gemm_int8_weights(wq, plan.cp)


@pytest.mark.parametrize("shape,cin,cout,n_clusters", [
    ((1, 3, 5, 11), 72, 3, 1),     # Z 11: one ragged z box; padded Cin and Cout
    ((1, 2, 4, 24), 64, 75, 2),    # Z 24: a full and a ragged z box
    ((1, 5, 3, 12), 200, 24, 3),   # Z 12, four padded chunks, odd boxes: an idle partner
    ((1, 2, 4, 16), 64, 8, 4),     # a single box: its partner idle, three clusters without a tile
    ((4, 1, 3, 7), 64, 16, 2),     # batch 4, X 1: the boxes of four volumes
    ((2, 3, 5, 9), 72, 300, 3),    # two blocks of 256 output channels
])
def test_walk_equals_the_plain_sums(shape, cin, cout, n_clusters):
    xq, wq = _operands(shape, cin, cout, cin + cout + shape[-1])
    plan = ci.Int8ConvPlan(xq.shape, cout)
    got, writes = walk(*_kernel_inputs(xq, wq, plan), plan, n_clusters)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, ci.int8_conv_sums_plain(xq, wq).long())


def test_walk_equals_the_jax_int32_conv():
    """The walk against the JAX package's int8 conv
    (``lax.conv_general_dilated(..., preferred_element_type=int32)``)."""
    shape, cin, cout = (2, 3, 6, 13), 80, 40
    xq, wq = _operands(shape, cin, cout, 7)
    kq = wq.numpy().transpose(2, 3, 4, 1, 0)  # (3, 3, 3, Cin, Cout)
    dn = jax.lax.conv_dimension_numbers(xq.shape, kq.shape, ("NXYZC", "XYZIO", "NXYZC"))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(kq), (1, 1, 1), "SAME", dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    plan = ci.Int8ConvPlan(xq.shape, cout)
    got, _ = walk(*_kernel_inputs(xq, wq, plan), plan, 5)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape,cout,boxes,pairs,tiles", [
    ((1, 80, 80, 96, 512), 256, (40, 20, 6), 2400, 2400),   # dec_3
    ((1, 80, 80, 96, 256), 256, (40, 20, 6), 2400, 2400),   # enc_1, final_0, final_1
    ((1, 20, 20, 24, 256), 256, (10, 5, 2), 50, 50),        # enc_3
    ((1, 10, 10, 12, 256), 256, (5, 3, 1), 8, 8),           # dec_0: 15 boxes, one idle block
    ((2, 21, 19, 13, 200), 75, (11, 5, 1), 55, 55),         # ragged, batch 2
    ((1, 2, 4, 16, 64), 300, (1, 1, 1), 1, 2),              # a single box, two column blocks
])
def test_plan_counts(shape, cout, boxes, pairs, tiles):
    plan = ci.Int8ConvPlan(shape, cout)
    assert plan.boxes_xyz == boxes and plan.n_pairs == pairs and plan.n_tiles == tiles
    assert plan.cp % 64 == 0 and plan.cp - 64 < shape[-1] <= plan.cp
    assert plan.cout_pad % 256 == 0 and plan.cout_pad - 256 < cout <= plan.cout_pad
    assert plan.launch_args() == (plan.cp, cout, plan.cout_pad, *ci.BOX, *boxes, tiles)
    # every box of the walk is a box of the volume, and the last pair's second one at most past it
    last = plan.tile(tiles - 1, 1)[0]
    assert last in (plan.n_boxes - 1, plan.n_boxes)
    assert plan.box_origin(plan.n_boxes)[0] == plan.B  # past the last box: out of the batch


def test_box_origins_cover_the_volume_once():
    plan = ci.Int8ConvPlan((3, 5, 9, 17, 64), 8)
    seen = torch.zeros((3, 5, 9, 17), dtype=torch.int64)
    for box in range(plan.n_boxes):
        b, x0, y0, z0 = plan.box_origin(box)
        assert x0 % ci.BOX[0] == 0 and y0 % ci.BOX[1] == 0 and z0 % ci.BOX[2] == 0
        seen[b, x0:x0 + ci.BOX[0], y0:y0 + ci.BOX[1], z0:z0 + ci.BOX[2]] += 1
        for dz in (-1, 0, 1):
            assert plan.halo_origin(box, dz) == (b, x0 - 1, y0 - 1, z0 + dz)
    assert torch.equal(seen, torch.ones_like(seen))
    # consecutive boxes pair up in a cluster: neighbours along z, then y
    assert [plan.tile(0, r)[0] for r in range(ci.CLUSTER)] == [0, 1]
    assert plan.box_origin(1) == (0, 0, 0, 16)


def test_tap_rows_are_whole_swizzle_atoms_inside_the_plane():
    """Each tap of each x-plane reads 64 consecutive rows of 64 bytes that
    start on a multiple of 16 rows (1024 bytes, two 512-byte swizzle atoms of
    the 64-byte swizzle) and stay inside the plane's 384 rows; row r of the
    tile is the halo voxel of output (xo, r // 16, r % 16) shifted by the tap."""
    hx, hy, hz = ci.HALO
    assert (hx, hy, hz) == (4, 6, 16) and hx * hy * hz == 384
    for xo in range(ci.BOX[0]):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                r0 = ci.Int8ConvPlan.tap_row(xo, dx, dy)
                assert r0 % 16 == 0 and 0 <= r0 and r0 + 64 <= hx * hy * hz
                for r in (0, 17, 63):
                    hxi, rest = divmod(r0 + r, hy * hz)
                    hyi, hzi = divmod(rest, hz)
                    assert (hxi, hyi, hzi) == (xo + 1 + dx, r // 16 + 1 + dy, r % 16)


def test_plan_matches_the_kernel_source_and_its_binding():
    """The constants of ``csrc/conv_int8.cu`` are the plan's, and the C
    launcher's arguments are the shape, the plan's and mode, slope, stream."""
    src = CU.read_text()
    const = {k: int(v) for k, v in re.findall(r"\b([A-Z_]+) = (\d+)\b", src)}
    assert (const["BOX_X"], const["BOX_Y"], const["BOX_Z"]) == ci.BOX
    assert const["KC"] == ci._K_CHUNK and const["BN"] == ci._N_TILE
    assert const["CLUSTER"] == ci.CLUSTER
    assert "HALO_X = BOX_X + 2, HALO_Y = BOX_Y + 2" in src and ci.HALO == (4, 6, 16)
    assert "mma.sync" not in src.split("#include")[1]  # the first version's instruction is gone
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in src
    n_args = len(kernels.CONV3_INT8._argtypes["conv3_int8_launch"])
    plan = ci.Int8ConvPlan((1, 4, 4, 4, 64), 8)
    assert n_args == 5 + 4 + len(plan.launch_args()) + 3


def test_weight_matrix_rows_pad_to_the_block_of_256():
    _, wq = _operands((1, 1, 1, 1), 72, 75, 3)
    plan = ci.Int8ConvPlan((1, 2, 2, 2, 72), 75)
    m = ci.gemm_int8_weights(wq, plan.cp)
    assert m.shape == (256, 27 * 128) and m.dtype == torch.int8
    assert not m[75:].any() and not m.reshape(256, 27, 128)[:, :, 72:].any()
    # column weight_col(tap, chunk) + ci holds wq[n, chunk * 64 + ci, dx, dy, dz]
    tap, chunk = 14, 1
    k0 = plan.weight_col(tap, chunk)
    assert torch.equal(m[:75, k0:k0 + 8], wq[:, 64:72, 1, 1, 2])
