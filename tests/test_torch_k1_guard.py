"""K1's 32-bit guard (``ops/conv_pool.py::_k1_index_fits``) on the CPU.

The guard holds what each of K1's two kernels (``csrc/conv_pool.cu``) forms in
32-bit ``int``, not the size of the whole batch: the bfloat16 kernel indexes
a batch element's input in ``int`` and the batch and the pooled output in 64
bits; the float32 kernel indexes its input in 64 bits and forms ``int``
counts of its weights, halo and work items. Both take the batch as
``gridDim.y`` (at most 65,535). So the w256 first level at 192^3 with batch 2
is served, as the JAX package serves it, and shapes that truly overflow are
refused with ``ValueError`` before anything is launched. The card test of
that shape against the plain version is in ``tests/test_torch_kernels.py``.
"""

import pytest
import torch

from multimodal_registration_torch.ops import conv_pool as tcp

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", [
    (2, 192, 192, 192, 2, 256),  # bench_torch.py --batch 2 --arch infer256: 3.6e9 by the old count
    (1, 160, 160, 192, 2, 64),   # the flagship's first level
    (1, 160, 160, 192, 2, 256),  # the published widths'
    (4, 80, 80, 96, 2, 64),      # subvolume tiles, a batch of 4
    (8, 192, 192, 192, 2, 64),
    (65_535, 2, 2, 2, 1, 8),     # the largest batch the grid takes
    (1, 1024, 1024, 1022, 2, 64),  # a batch element's input just below 2^31 values
])
def test_guard_admits_what_the_kernels_index_in_32_bits(shape, dtype):
    assert tcp._k1_index_fits(*shape, dtype)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_guard_refuses_a_batch_beyond_the_grid(dtype):
    assert not tcp._k1_index_fits(65_536, 2, 2, 2, 1, 8, dtype)


def test_bf16_refuses_a_batch_element_input_of_2_to_the_31_values():
    # the bf16 kernel's ((gx * Y + gy) * Z + gz) * Cin is an int
    assert not tcp._k1_index_fits(1, 1024, 1024, 1024, 2, 64, BF16)
    assert tcp._k1_index_fits(1, 1024, 1024, 1024, 1, 64, BF16)  # 2^30 values
    # the float32 kernel reads its input through 64-bit offsets
    assert tcp._k1_index_fits(1, 1024, 1024, 1024, 2, 64, F32)


def test_bf16_refuses_a_halo_index_of_2_to_the_31():
    # v * CP2 + c2 over the 10 x 18 x 18 halo: CP2 = 662,804 words pass 2^31 - 1
    assert not tcp._k1_index_fits(1, 2, 2, 2, 2 * 662_804, 8, BF16)
    assert tcp._k1_index_fits(1, 2, 2, 2, 2 * 662_803, 8, BF16)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_both_refuse_more_blocks_than_grid_dim_x_takes(dtype):
    # float32: 2 x 4 x 8 pooled voxels a block; 2^11 * 2^10 * 2^10 = 2^31 blocks
    assert not tcp._k1_index_fits(1, 2**13, 2**13, 2**14, 1, 8, dtype)


def test_f32_refuses_int_counts_of_weights_halo_and_work_items():
    assert not tcp._k1_index_fits(1, 4, 4, 4, 2**14, 2**14, F32)  # 27 * Cin * Cout
    assert not tcp._k1_index_fits(1, 4, 4, 4, 2**21, 1, F32)      # 6 * 10 * 18 * Cin
    assert not tcp._k1_index_fits(1, 4, 4, 4, 1, 2**25, F32)      # 64 * Cout
    assert tcp._k1_index_fits(1, 4, 4, 4, 2**10, 2**10, F32)


def test_a_dim_beyond_a_c_int_is_refused():
    assert not tcp._k1_index_fits(1, 2**31, 2, 2, 1, 8, F32)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", [(65_536, 2, 2, 2, 1), (1, 1024, 1024, 1024, 2)])
def test_the_wrapper_keeps_its_value_error(monkeypatch, shape, dtype):
    """The wrapper as it runs for a tensor on the card, given shapes that do not
    fit (meta tensors: nothing is allocated, nothing launched)."""
    if dtype == F32 and shape[0] == 1:
        shape = (1, 2**13, 2**13, 2**14, 1)  # float32 overflows only its grid here
    monkeypatch.setattr(tcp, "use_kernel", lambda t, impl: True)
    x = torch.empty(shape, dtype=dtype, device="meta")
    w = torch.empty((8, shape[-1], 3, 3, 3), device="meta")
    b = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="too large for 32-bit indices"):
        tcp.conv3_lrelu_pool(x, w, b)
