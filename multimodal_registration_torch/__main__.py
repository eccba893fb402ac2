"""The port's command line:

    python -m multimodal_registration_torch <command> [flags]

Commands (each takes the flags of the JAX package's CLI of the same name,
plus ``--device``; ``--help`` lists them):

  bids-registration    BIDS single-model registration (bids_registration.py)
  bids-two-steps       BIDS two-step cascade (bids_two_steps_registration.py)
  gen-apply-def-field  draw a Perlin field and apply it (gen_apply_def_field.py)
  quant-calibrate      write a checkpoint's int8 scale sidecar (mmreg-calibrate)
  eval-on-sc-seg       Dice etc. on segmentations (eval_reg_on_sc_seg.py)
  eval-with-mi         normalized mutual information (eval_reg_with_mi.py)
  eval-with-jacobian   Jacobian determinant / folding (eval_reg_with_jacobian.py)
  pipeline             BIDS batch register + evaluate + QC
                       (pipeline_bids_register_evaluate.py; --opt-affine for
                       the _opt_affine variant, --model2-path for _two_steps)

Pair registration (3d_reg.py) is ``python -m
multimodal_registration_torch.infer.cli``, training (train_synthmorph.py)
``python -m multimodal_registration_torch.train.cli``.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "bids-registration": ("multimodal_registration_torch.infer.cli", "bids_registration"),
    "bids-two-steps": ("multimodal_registration_torch.infer.cli", "bids_two_steps"),
    "gen-apply-def-field": ("multimodal_registration_torch.infer.cli", "gen_apply_def_field"),
    "quant-calibrate": ("multimodal_registration_torch.infer.cli", "quant_calibrate"),
    "eval-on-sc-seg": ("multimodal_registration_torch.evalx.cli", "eval_on_sc_seg"),
    "eval-with-mi": ("multimodal_registration_torch.evalx.cli", "eval_with_mi"),
    "eval-with-jacobian": ("multimodal_registration_torch.evalx.cli", "eval_with_jacobian"),
    "pipeline": ("multimodal_registration_torch.pipeline.batch", "main"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__, file=sys.stderr)
        return 0 if argv[:1] in (["-h"], ["--help"]) else 2
    module, name = COMMANDS[argv[0]]
    out = getattr(importlib.import_module(module), name)(argv[1:])
    return out if isinstance(out, int) else 0


if __name__ == "__main__":
    sys.exit(main())
