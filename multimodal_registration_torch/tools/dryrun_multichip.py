"""The multi-device dry run of the port: its counterpart of the JAX
package's ``__graft_entry__.py::dryrun_multichip``.

    python -m multimodal_registration_torch.tools.dryrun_multichip [N] [--device cpu]
        [--devices cuda:0,cuda:0]

On ``N`` devices (default 2): every card of the machine by default, the CPU
``N`` times with ``--device cpu``, or the list ``--devices`` names (one
device may repeat, which is how a one-card machine runs it). Raises on any
mismatch; prints one summary line. Sections, numbered as the JAX dry run's
(3 and 3b exercise the TPU's warp modes, which the port does not have):

  1. one data-parallel training step over ``N`` replicas equals the 1-device
     step on the same generator, maps and parameters (loss within ``1e-5 +
     1e-5 |loss|``, every parameter within rtol 1e-4 / atol 2e-5);
  2. the space-sharded forward (``space`` 2 when ``N`` is even) equals the
     unsharded one on random input (rtol/atol 1e-5);
  4. ``pair_registration --space`` writes the single-device outputs;
  5. the int8 forward space-sharded equals the single-device one;
  6. ``bids_two_steps --space`` writes the single-device outputs.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from multimodal_registration_torch.infer import selftest
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.parallel.mesh import make_mesh, mesh_devices, replicate
from multimodal_registration_torch.parallel.spatial import forward_slabs
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer


def dp_step_check(devices, n: int) -> tuple:
    """Section 1: ``(loss of the n-replica step, loss of the 1-device step)``."""
    cfg = TrainConfig.from_dict(dict(
        in_shape=[16, 16, 16], num_labels=4, num_maps=n, im_scales=[4], def_scales=[4],
        vel_res=4.0, bias_res=8.0, batch_size=n, num_devices=n, enc=[4] * 4, dec=[4] * 6,
        compute_dtype="float32", epochs=1))
    maps = np.random.default_rng(0).integers(0, 4, size=(n, 16, 16, 16), dtype=np.uint8)
    out = []
    for mesh in (make_mesh(n, devices=devices), make_mesh(1, devices=devices)):
        trainer = Trainer(cfg, mesh=mesh)
        trainer.init_state(seed=7)
        src, trg = trainer.put_batch(maps.copy(), maps.copy())
        aux = trainer.train_step(trainer.generator(0), src, trg)
        out.append((float(aux["loss"]), [p.detach().cpu() for p in trainer.model.parameters()]))
    (loss, params), (loss1, params1) = out
    assert np.isfinite(loss), f"non-finite loss in the multi-device dry run: {loss}"
    assert abs(loss - loss1) <= 1e-5 + 1e-5 * abs(loss1), (
        f"DP loss mismatch: {n}-replica {loss} vs 1-device {loss1}")
    for a, b in zip(params, params1):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5,
                                   msg=lambda m: f"DP params diverged from the 1-device step: {m}")
    return loss, loss1


def space_forward_check(devices, n: int, space: int) -> None:
    """Section 2: the forward with X over ``space`` devices, ``n // space``
    data rows, equals the unsharded forward on random input."""
    mesh = make_mesh(n, space=space, devices=devices)
    vcfg = VxmConfig(enc=(4, 4), dec=(4, 4, 4), int_steps=3, int_res=2, svf_res=2,
                     compute_dtype="float32")
    home = VxmDense(vcfg, device=mesh.home).eval()
    models = replicate(home, mesh.distinct())
    rng = np.random.default_rng(11)
    b = mesh.shape["data"]
    mov = torch.as_tensor(rng.random((b, 32, 16, 16, 1), np.float32))
    fx = torch.as_tensor(rng.random((b, 32, 16, 16, 1), np.float32))
    with torch.inference_mode():
        out = torch.cat([forward_slabs(models, list(mesh.devices[r]), mov[r:r + 1].to(
            mesh.devices[r, 0]), fx[r:r + 1].to(mesh.devices[r, 0]))["moved"].cpu()
            for r in range(b)])
        ref = home(mov.to(mesh.home), fx.to(mesh.home))["moved"].cpu()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5,
                               msg="space-sharded forward != unsharded forward on random input")


def dryrun_multichip(n_devices: int = 2, device=None) -> str:
    """Run the sections on ``n_devices`` of the devices ``device`` offers
    (``parallel/mesh.py::mesh_devices``); returns the summary line."""
    devices = mesh_devices(device, n_devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}: name them with "
                         "--devices (cuda:0,cuda:0) or pass --device cpu")
    devices = devices[:n_devices]
    spec = ",".join(str(d) for d in devices)
    loss, loss1 = dp_step_check(devices, n_devices)
    space = 2 if n_devices % 2 == 0 else 1
    parts = [f"dryrun_multichip({n_devices}) on {spec}: train-step loss={loss:.4f} "
             f"(== 1-dev loss {loss1:.4f}, params allclose)"]
    if space > 1:
        space_forward_check(devices, n_devices, space)
        pair = ",".join(str(d) for d in devices[:space])
        with tempfile.TemporaryDirectory() as td:
            selftest.cli_space_parity_check(space, td, seed=3, device=pair)
        selftest.int8_sharded_forward_check(space, device=pair)
        with tempfile.TemporaryDirectory() as td:
            selftest.cli_cascade_space_parity_check(space, td, seed=5, device=pair)
        parts += [f"spatial-sharded forward ok (space={space})",
                  f"sharded CLI ok (space={space}, outputs == single-device)",
                  f"int8 sharded forward ok (space={space}, quantized outputs == single-device)",
                  f"sharded two-step cascade CLI ok (space={space})"]
    else:
        parts.append("space sections skipped (odd device count)")
    line = ", ".join(parts)
    print(line, flush=True)
    return line


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--device", default=None,
                   help="cuda (default: every card) or cpu (the CPU, N times)")
    p.add_argument("--devices", default=None,
                   help="the mesh's devices in order, comma-separated (cuda:0,cuda:0)")
    args = p.parse_args(argv)
    return dryrun_multichip(args.n_devices, args.devices or args.device)


if __name__ == "__main__":
    main()
