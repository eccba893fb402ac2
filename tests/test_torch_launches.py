"""The kernel launches that a forward and a training step state of themselves.

``VxmDense.kernel_launches`` and ``Trainer.step_launches`` derive, from the
model's and the trainer's config, what one inference forward and one training
step launch on the card; every launch check of the port (``chip_smoke.py``,
``bench_torch.py``, ``tools/train_bench.py``) reads them. Here each is held
to the literal table of its configuration, so that a count that does not
follow the config fails. On the CPU nothing launches: the card test
``tests/test_torch_kernels.py -k states`` counts the launches themselves."""

import pytest

from multimodal_registration_torch import kernels
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.parallel.mesh import make_mesh
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer

W256 = dict(enc=(256,) * 4, dec=(256,) * 6)
FLAGSHIP_FWD = dict(conv3_lrelu_pool=1, warp_trilinear=5, warp_up2x=1, flow_head=1, up_cat=3,
                    bias_lrelu=9, conv3_lrelu_pool_launch=1, self_warp_add_launch=5,
                    warp_up2x_launch=1, flow_head_fwd_launch=1, up_cat_launch=3,
                    bias_lrelu_launch=9)
# the nine library convs on K8, so none on K11
INT8 = dict(conv3_int8=9, conv3_int8_launch=9, bias_lrelu=0, bias_lrelu_launch=0)
SLABS2_FWD = dict(FLAGSHIP_FWD, conv3_lrelu_pool=2, conv3_lrelu_pool_launch=2, flow_head=2,
                  flow_head_fwd_launch=2, up_cat=6, up_cat_launch=6, bias_lrelu=18,
                  bias_lrelu_launch=18)
TRAIN_B1 = dict(warp_trilinear=11, max_pool_2x_bwd=4, warp_trilinear_bwd=6,
                warp_labels_soft_hard=3, warp_labels_bwd=1, flow_head=4)


def _table(**launched):
    """Every kernel at 0 but those ``launched``, and the launched C entries."""
    return {**dict.fromkeys((k.name for k in kernels.KERNELS), 0), **launched}


FORWARDS = {
    "flagship": ({}, 1, FLAGSHIP_FWD),
    "w256": (W256, 1, FLAGSHIP_FWD),
    "w256_int8": (dict(W256, quantize="int8"), 1, dict(FLAGSHIP_FWD, **INT8)),
    "flagship_slabs2": ({}, 2, SLABS2_FWD),
    "w256_int8_slabs2": (dict(W256, quantize="int8"), 2,
                         dict(SLABS2_FWD, conv3_int8=18, conv3_int8_launch=18, bias_lrelu=0,
                              bias_lrelu_launch=0)),
    "int_steps7": (dict(int_steps=7), 1,
                   dict(FLAGSHIP_FWD, warp_trilinear=7, self_warp_add_launch=7)),
    # the field at full resolution: K2's general warp moves the image, no K3
    "int_res1": (dict(int_res=1), 1,
                 dict(FLAGSHIP_FWD, warp_trilinear=6, warp_up2x=0, warp_up2x_launch=0,
                      warp_launch=1)),
    "three_levels": (dict(enc=(64,) * 3, dec=(64,) * 5), 1,
                     dict(FLAGSHIP_FWD, up_cat=2, up_cat_launch=2, bias_lrelu=7,
                          bias_lrelu_launch=7)),
    # svf_res 1: the decoder reads enc_0's full-res activation, so no K1 (enc_0
    # a library conv, on K11), and every level upsamples
    "svf_res1": (dict(svf_res=1, int_res=1), 1,
                 dict(FLAGSHIP_FWD, conv3_lrelu_pool=0, conv3_lrelu_pool_launch=0,
                      warp_trilinear=6, warp_up2x=0, warp_up2x_launch=0, warp_launch=1,
                      up_cat=4, up_cat_launch=4, bias_lrelu=10, bias_lrelu_launch=10)),
}


@pytest.mark.parametrize("case", sorted(FORWARDS))
def test_forward_states_its_launches(case):
    over, slabs, want = FORWARDS[case]
    model = VxmDense(VxmConfig(**over), device="meta")
    assert model.kernel_launches(slabs) == _table(**{k: v for k, v in want.items() if v})


# a forward that makes no moved image (the tiles of use_subvol): no K3, and
# with the field at full resolution no general warp either
WITHOUT_MOVED = {
    "flagship": ({}, dict(FLAGSHIP_FWD, warp_up2x=0, warp_up2x_launch=0)),
    "int_res1": (dict(int_res=1), dict(FLAGSHIP_FWD, warp_up2x=0, warp_up2x_launch=0)),
    "w256_int8": (dict(W256, quantize="int8"),
                  dict(FLAGSHIP_FWD, **INT8, warp_up2x=0, warp_up2x_launch=0)),
}


@pytest.mark.parametrize("case", sorted(WITHOUT_MOVED))
def test_a_forward_without_its_moved_image_states_no_warp_of_it(case):
    over, want = WITHOUT_MOVED[case]
    model = VxmDense(VxmConfig(**over), device="meta")
    assert model.kernel_launches(with_moved=False) == _table(
        **{k: v for k, v in want.items() if v})


def test_a_calibrating_int8_forward_states_no_k8():
    model = VxmDense(VxmConfig(**W256, quantize="int8"), device="meta", quant_calibrate=True)
    assert model.kernel_launches() == _table(**FLAGSHIP_FWD)


STEPS = {
    "b1": ({}, 1, TRAIN_B1),
    "b2": (dict(batch_size=2), 1, dict(TRAIN_B1, warp_labels_soft_hard=5)),
    "int_steps3": (dict(int_steps=3), 1, dict(TRAIN_B1, warp_trilinear=9, warp_trilinear_bwd=4)),
    "three_levels": (dict(enc=[64] * 3, dec=[64] * 5), 1, dict(TRAIN_B1, max_pool_2x_bwd=3)),
    # no reduced grid: each generator's field is integrated on its own
    "b2_svf_int_res1": (dict(batch_size=2, svf_int_res=1), 1,
                        dict(TRAIN_B1, warp_trilinear=26, warp_labels_soft_hard=5)),
    # two replicas at batch 2: each runs the step at batch 1
    "b2_two_replicas": (dict(batch_size=2, num_devices=2), 2,
                        {k: 2 * v for k, v in TRAIN_B1.items()}),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_training_step_states_its_launches(case):
    over, replicas, want = STEPS[case]
    cfg = TrainConfig.from_dict(dict(in_shape=[32, 32, 32], num_labels=4, **over))
    trainer = Trainer(cfg, mesh=make_mesh(replicas, devices=["cpu", "cpu:0"][:replicas]))
    assert trainer.step_launches() == _table(**want)
