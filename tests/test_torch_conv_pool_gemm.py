"""Kernel K1's tensor-core formulation, on the CPU: the implicit GEMM that
``csrc/conv_pool.cu`` runs for bfloat16 is repeated here with plain torch from
the operands the wrapper prepares (``gemm_weight_matrix``, cut by
``wgmma_b_tiles``) and in the kernel's row order (``window_row_order``), and
held against the port's plain version and the JAX package's reference. The
kernel itself is held against its plain version on the card in
``test_torch_kernels.py``.

Tolerance: 1 bf16 ulp of max|out|. All sides sum the same products of
bf16-rounded operands in float32, in different orders; the one rounding to
bf16 at the end may then fall on either side of a boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import multimodal_registration_tpu.ops.pallas.conv_pool as jcp
from multimodal_registration_torch.ops import conv_pool as tcp

from _torch_port import bf16_ulp, rand, t


def _bf16_round(a):
    return t(a, torch.bfloat16).float()


def _tiles_to_matrix(tiles, k_pad, cout_pad):
    """Undo ``wgmma_b_tiles`` by the layout its docstring states."""
    chunks = -(-cout_pad // 64)
    m = torch.zeros((k_pad, 64 * chunks), dtype=tiles.dtype)
    f = tiles.reshape(chunks, k_pad // 16, 2, 8, 8, 8)
    for chunk in range(chunks):
        for step in range(k_pad // 16):
            for kb in range(2):
                for nb in range(8):
                    for ni in range(8):
                        for ki in range(8):
                            m[16 * step + 8 * kb + ki, 64 * chunk + 8 * nb + ni] = f[
                                chunk, step, kb, nb, ni, ki]
    assert float(m[:, cout_pad:].abs().sum()) == 0.0  # the columns that complete 64
    return m[:, :cout_pad]


def _gemm_conv_pool(x, w, b, slope=0.2):
    """``x (X, Y, Z, Cin)`` float32 holding bf16 values -> pooled float32
    ``(X/2, Y/2, Z/2, Cout)``, the way the kernel computes it: im2col rows of
    the zero-padded input in the kernel's row order times the prepared weight
    matrix, float32 sums, bias, LeakyReLU, max over the rows of a window."""
    X, Y, Z, cin = x.shape
    cout = w.shape[0]
    cin_p = cin + cin % 2
    m = tcp.gemm_weight_matrix(w)
    k_pad, cout_pad = m.shape
    assert m.dtype == torch.bfloat16
    assert k_pad % 16 == 0 and k_pad - 27 * cin_p < 16 and cout_pad % 8 == 0 and cout_pad - cout < 8
    m = _tiles_to_matrix(tcp.wgmma_b_tiles(m), k_pad, cout_pad).float()

    xp = F.pad(x, (0, cin_p - cin, 1, 1, 1, 1, 1, 1))  # channels to even, SAME zeros around
    taps = [xp[dx:dx + X, dy:dy + Y, dz:dz + Z] for dx in range(3) for dy in range(3)
            for dz in range(3)]
    a = F.pad(torch.stack(taps, 3).reshape(X, Y, Z, 27 * cin_p), (0, k_pad - 27 * cin_p))

    order = tcp.window_row_order()  # [tile, row] -> (window, vx, vy, vz)
    out = torch.full((X // 2, Y // 2, Z // 2, cout), float("nan"))
    assert (Z // 2) % 8 == 0
    for px in range(X // 2):
        for py in range(Y // 2):
            for pz0 in range(0, Z // 2, 8):  # a warp's group: 8 windows along z
                rows = a[2 * px + order[..., 1], 2 * py + order[..., 2],
                         2 * (pz0 + order[..., 0]) + order[..., 3]]      # (4, 16, K_pad)
                acc = F.leaky_relu(rows @ m + F.pad(b, (0, cout_pad - cout)), slope)
                for g in range(8):
                    out[px, py, pz0 + g] = acc[order[..., 0] == g].amax(0)[:cout]
    return out


@pytest.mark.parametrize("cout", [3, 12, 64])
@pytest.mark.parametrize("cin", [1, 2, 3, 4])
def test_gemm_formulation_matches_plain_and_jax_reference(cin, cout):
    x = _bf16_round(rand((4, 6, 16, cin), 100 + cin))
    w_jax = rand((3, 3, 3, cin, cout), 200 + cout, 0.2)
    b = rand((cout,), 300)
    w = t(np.ascontiguousarray(w_jax.transpose(4, 3, 0, 1, 2)))
    got = _gemm_conv_pool(x, w, t(b))
    plain = tcp.conv3_lrelu_pool(x.bfloat16()[None], w, t(b))[0]
    want_jax = np.asarray(jcp.conv3_lrelu_pool_reference(
        jnp.asarray(x.numpy()), jnp.asarray(_bf16_round(w_jax).numpy()), jnp.asarray(b)))
    assert got.shape == plain.shape == want_jax.shape == (2, 3, 8, cout)
    tol = bf16_ulp(np.abs(want_jax).max())
    assert float((got.bfloat16().float() - plain.float()).abs().max()) <= tol
    assert np.abs(got.bfloat16().float().numpy() - want_jax).max() <= tol


def test_weight_matrix_row_order_and_padding():
    w = t(rand((5, 3, 3, 3, 3), 400))
    m = tcp.gemm_weight_matrix(w)
    assert m.shape == (112, 8)  # Cin 3 -> 4: K 108 -> 112; Cout 5 -> 8
    wb = w.bfloat16()
    for (dx, dy, dz, ci, co) in [(0, 0, 0, 0, 0), (2, 1, 0, 2, 4), (1, 2, 2, 1, 3)]:
        assert m[((dx * 3 + dy) * 3 + dz) * 4 + ci, co] == wb[co, ci, dx, dy, dz]
    assert float(m[3::4].abs().max()) == 0.0    # the channel that pads Cin to even
    assert float(m[108:].abs().max()) == 0.0    # the rows that pad K
    assert float(m[:, 5:].abs().max()) == 0.0   # the columns that pad Cout


def test_b_tiles_are_a_permutation_of_the_matrix():
    for cout_pad in (128, 24):  # whole chunks of 64 columns, and not
        m = torch.arange(1, 64 * cout_pad + 1, dtype=torch.float32).reshape(64, cout_pad)
        tiles = tcp.wgmma_b_tiles(m)
        assert sorted(v for v in tiles.tolist() if v) == m.reshape(-1).tolist()
        assert torch.equal(_tiles_to_matrix(tiles, 64, cout_pad), m)
    # the byte offset of an entry inside its 2048-byte tile, as the kernel's
    # matrix descriptor states it
    m = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    tiles = tcp.wgmma_b_tiles(m)
    for k, n in [(0, 0), (3, 5), (9, 63), (15, 8)]:
        offset = (k // 8) * 1024 + (n // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
        assert tiles[offset // 2] == m[k, n]


def test_window_row_order_maps_every_voxel_to_exactly_one_window():
    order = tcp.window_row_order()
    assert order.shape == (4, 16, 4)
    seen = {tuple(r) for r in order.reshape(-1, 4).tolist()}
    assert seen == {(g, vx, vy, vz) for g in range(8) for vx in (0, 1) for vy in (0, 1)
                    for vz in (0, 1)}
    # rows g and g + 8 of a tile belong to window g: one lane's accumulators
    assert torch.equal(order[:, :8, 0], order[:, 8:, 0])
    assert torch.equal(order[:, :8, 0], torch.arange(8).expand(4, 8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepared_weights_are_cached_per_parameter_version(dtype):
    w = t(rand((4, 2, 3, 3, 3), 500))
    b = t(rand((4,), 501))
    wk, bk = tcp.prepared_weights(w, b, dtype)
    again = tcp.prepared_weights(w, b, dtype)
    assert again[0] is wk and again[1] is bk
    # another compute type is another entry
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    assert tcp.prepared_weights(w, b, other)[0] is not wk
    with torch.no_grad():
        w.mul_(2.0)  # an in-place update bumps w._version
    fresh, _ = tcp.prepared_weights(w, b, dtype)
    assert fresh is not wk
    torch.testing.assert_close(fresh.float(), 2.0 * wk.float(), atol=0, rtol=0)
    with torch.no_grad():
        b.add_(1.0)
    assert torch.equal(tcp.prepared_weights(w, b, dtype)[1], b.float())


def test_prepared_weights_of_inference_tensors_are_not_cached():
    """Tensors made under ``torch.inference_mode`` track no version, so an
    in-place update could not be seen: they are prepared anew on every call."""
    with torch.inference_mode():
        w = t(rand((4, 2, 3, 3, 3), 800))
        b = t(rand((4,), 801))
        before = len(tcp._PREPARED)
        first = tcp.prepared_weights(w, b, torch.bfloat16)[0]
        w.mul_(2.0)
        second = tcp.prepared_weights(w, b, torch.bfloat16)[0]
    assert len(tcp._PREPARED) == before and second is not first
    torch.testing.assert_close(second.float(), 2.0 * first.float(), atol=0, rtol=0)


def test_prepared_weights_cache_stays_small():
    keep = [(t(rand((4, 2, 3, 3, 3), 600 + i)), t(rand((4,), 700 + i))) for i in range(12)]
    for w, b in keep:
        tcp.prepared_weights(w, b, torch.bfloat16)
    assert len(tcp._PREPARED) <= 8
    w, b = keep[-1]  # the newest entries are the ones kept
    assert tcp.prepared_weights(w, b, torch.bfloat16)[0] is tcp.prepared_weights(
        w, b, torch.bfloat16)[0]
