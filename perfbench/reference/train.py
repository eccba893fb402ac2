"""Plain float32 reference of one SynthMorph training step as the port's
trainer takes it at ``config/config.json``'s settings (batch 1, lr 1e-4,
``reg_param`` 1, no zero borders; the port's defaults ``compose_res`` 2,
``grad_res`` 1, ``svf_int_res`` 4, no clipping): synthesise the pair, register
it, compose the generator's quarter-grid field with the model's half-grid
field on the half grid and upsample the sum, warp the source labels' one-hot
by it, and take ``dice(map2, pred) + 1 + Grad('l2')`` of the full-res field;
then Adam (``optax.adam``'s defaults: b1 0.9, b2 0.999, eps 1e-8).
"""

from __future__ import annotations

import torch

from perfbench.reference import model as ref_model
from perfbench.reference import ops, synth


def dice_loss(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Soft Dice over one-hot channels ``(B, X, Y, Z, L)``, mean over batch
    and labels, negated; a label absent from both maps counts 0."""
    top = 2.0 * (t * p).sum(dim=(1, 2, 3))
    bottom = (t + p).sum(dim=(1, 2, 3))
    ok = bottom > 0
    return -torch.where(ok, top / torch.where(ok, bottom, torch.ones_like(bottom)),
                        torch.zeros_like(top)).mean()


def grad_l2(field: torch.Tensor) -> torch.Tensor:
    """Mean squared forward difference of ``(B, X, Y, Z, 3)`` per axis,
    averaged over the axes and the batch."""
    total = 0.0
    for axis in (1, 2, 3):
        d = torch.diff(field, dim=axis)
        total = total + (d * d).reshape(d.shape[0], -1).mean(-1)
    return (total / 3).mean()


def soft_onehot(labels: torch.Tensor, field: torch.Tensor, num_labels: int) -> torch.Tensor:
    """Trilinear warp of ``one_hot(labels)`` ``(X, Y, Z)`` by ``field (X, Y, Z,
    3)``, differentiable in the field: ``(1, X, Y, Z, L)``."""
    shape = tuple(labels.shape)
    n = shape[0] * shape[1] * shape[2]
    coords = (ops.grid(shape, field.device) + field).reshape(1, n, 3)
    flat = labels.reshape(1, n).long()
    soft = torch.zeros((1, n, num_labels), dtype=torch.float32, device=field.device)
    for idx, w in ops.corners(shape, coords):
        soft = soft.scatter_add(2, torch.gather(flat, 1, idx)[..., None], w[..., None])
    return soft.reshape(1, *shape, num_labels)


def loss(weights: dict, batch: dict, model: dict, num_labels: int, reg_param: float,
         conv=ref_model.conv3d) -> torch.Tensor:
    """The step's loss on a synthesised batch (batch 1)."""
    shape = tuple(batch["img1"].shape)
    warp, full = ref_model.train_forward(weights, batch["img1"][None], batch["img2"][None],
                                         model, conv)
    half = tuple(warp.shape[1:4])
    small = tuple(batch["phi1s"].shape[:3])
    if any(h != 2 * s for h, s in zip(half, small)):
        raise NotImplementedError("the reference composes a quarter-grid generator field only")
    gen_half = ops.rescale_field(batch["phi1s"], 2.0, half)[None]
    total_half = warp + ops.warp(gen_half, warp)
    total = ops.upsample2x_field(total_half, shape)[0]
    pred = soft_onehot(batch["raw1"], total, num_labels)
    return dice_loss(batch["map2"][None], pred) + 1.0 + reg_param * grad_l2(full)


def synthesise(gen, bank: torch.Tensor, src: int, trg: int, cfg: dict) -> dict:
    """The batch of one step: its draws from ``gen`` in the program's order,
    then the two images."""
    dev = bank.device
    shape = tuple(bank.shape[1:])
    mask = synth.draw_pair(gen, dev)
    s_lab, t_lab = synth.flip(mask, bank[src]), synth.flip(mask, bank[trg])
    d1 = synth.draw_sample(gen, shape, cfg, dev)
    d2 = synth.draw_sample(gen, shape, cfg, dev)
    with torch.no_grad():
        a = synth.image(s_lab, d1, cfg)
        b = synth.image(t_lab, d2, cfg)
    return {"img1": a["img"], "img2": b["img"], "raw1": s_lab, "phi1s": a["phi_small"],
            "map2": b["soft"]}


class Adam:
    """``torch.optim.Adam`` with ``optax.adam``'s defaults, written out."""

    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, state: dict | None = None):
        """``state``: ``{"t": steps taken, "m": {...}, "v": {...}}`` to start
        from (copied); fresh moments when None."""
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = int(state["t"]) if state else 0
        self.m = {k: (state["m"][k].clone() if state else torch.zeros_like(v))
                  for k, v in params.items()}
        self.v = {k: (state["v"][k].clone() if state else torch.zeros_like(v))
                  for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + self.eps
            p.sub_(self.lr / c1 * self.m[k] / denom)


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to a float8 type, one scale a tensor (its largest
    magnitude at the type's largest finite value)."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).float() * s


class _Fp8Conv(torch.autograd.Function):
    """A SAME 3x3x3 conv whose input and weight are rounded to e4m3 and whose
    output gradient is rounded to e5m2 before the data and weight gradients
    are taken (the usual float8 training recipe), in float32 otherwise."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return torch.nn.functional.conv3d(xq, wq, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        gx = torch.nn.grad.conv3d_input(xq.shape, wq, gq, padding=1)
        gw = torch.nn.grad.conv3d_weight(xq, wq.shape, gq, padding=1)
        return gx, gw, g.sum((0, 2, 3, 4))


class _Fp8Cast(torch.autograd.Function):
    """A tensor stored in e4m3, its gradient in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def fp8_conv(x, w, b):
    """The control's conv: the U-Net's convs forward and backward in float8,
    the nearest precision below the configuration's bf16."""
    return _Fp8Conv.apply(x, w, b)


# the U-Net's features reach the float32 head in the compute type, as in the program
fp8_conv.features = _Fp8Cast.apply


def _step(params: dict, opt: Adam, gen, bank: torch.Tensor, src: int, trg: int, cfg: dict,
          model: dict, conv) -> tuple:
    """One step in place: ``(loss, gradients)``."""
    batch = synthesise(gen, bank, src, trg, cfg)
    value = loss(params, batch, model, cfg["num_labels"], cfg["reg_param"], conv)
    del batch
    grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
    opt.step(params, grads)
    return float(value.detach()), grads


def steps(weights: dict, bank: torch.Tensor, src, trg, gen, cfg: dict, model: dict,
          count: int, conv=ref_model.conv3d) -> dict:
    """``count`` training steps from ``weights`` (left unchanged): the loss of
    each, the first step's gradients, the parameters after the last."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = Adam(params, cfg["lr"])
    losses, first = [], None
    for i in range(count):
        value, grads = _step(params, opt, gen, bank, int(src[i]), int(trg[i]), cfg, model, conv)
        losses.append(value)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        del grads
    return {"losses": losses, "grads": first,
            "params": {k: v.detach() for k, v in params.items()}}


def step_from(weights: dict, state: dict, bank: torch.Tensor, src: int, trg: int, gen,
              cfg: dict, model: dict, conv=ref_model.conv3d) -> dict:
    """One training step from a state taken in the middle of a run: the
    parameters ``weights``, Adam's ``state`` (``{"t", "m", "v"}``) and ``gen``
    at the program's position; its loss, gradients and the parameters after."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = Adam(params, cfg["lr"], state=state)
    value, grads = _step(params, opt, gen, bank, int(src), int(trg), cfg, model, conv)
    return {"loss": value, "grads": grads,
            "params": {k: v.detach() for k, v in params.items()}}
