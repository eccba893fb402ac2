from multimodal_registration_torch.losses.losses import (  # noqa: F401
    dice_loss,
    dice_loss_zeropad,
    grad_loss,
    mse_loss,
    ncc_loss,
)
