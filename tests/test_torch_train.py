"""The port's trainer (``train/``) against the JAX package's, on the CPU.

(a) One loss evaluation and its gradients w.r.t. every parameter, on the same
synthesised batch (made by the JAX package from a key; the port's
``loss_from_batch`` is handed it) and the same weights, float32 compute and
float32 payloads: loss within 1e-5, every gradient leaf within 2e-5 of the
leaf's largest entry (float32 sums in another order through ten convs and
five squaring steps; measured 3e-6). The JAX side runs its production sampler
(``MMREG_WARP_MODE=packed``), whose gradient the port follows on the far
bound (see the port's ``ops/warp.py``).
(b) One Adam step from those gradients gives the same parameters. Adam's
first step is ``lr * g / (|g| + 1e-8)``: where ``|g|`` is far above 1e-8 it
is ``lr * sign(g)`` and must agree to 1e-3 of ``lr``; where a gradient is
within rounding of zero the step can differ by up to ``2 * lr``.
The counterparts of the JAX package's ``tests/test_train.py`` and the
checkpoint exchange are in ``test_torch_train_cli.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.synth import augment as jaug
from multimodal_registration_tpu.synth import image_engine as jeng
from multimodal_registration_tpu.train import trainer as jtr
from multimodal_registration_tpu.train.config import TrainConfig as JTrainConfig
from multimodal_registration_torch.models.weights import (grads_to_jax, params_from_jax,
                                                          params_to_jax)
from multimodal_registration_torch.train import trainer as ttr
from multimodal_registration_torch.train.config import TrainConfig

from _torch_port import label_maps, random_flat_params
from _torch_port import tiny_train_cfg as tiny


@pytest.fixture(autouse=True)
def jax_production_sampler(monkeypatch):
    monkeypatch.setenv("MMREG_WARP_MODE", "packed")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many tiny operators: a thread pool per operator only fights the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- (a), (b): loss, gradients and one Adam step against JAX -----------------

def jax_synthesize(key, src, trg, engine_cfg):
    """The batch ``train/trainer.py::make_loss_fn``'s ``synthesize`` makes
    (no zero borders), by the same key schedule: ``split(key, B)``, then per
    sample ``split(k, 5)`` -> flips, (two unused), generator 1, generator 2."""
    cols = {k: [] for k in ("img1", "raw1", "phi1", "phi1s", "img2", "map2")}
    for b, k in enumerate(jax.random.split(key, src.shape[0])):
        k_flip, _, _, k_g1, k_g2 = jax.random.split(k, 5)
        s, t = jaug.random_flips(k_flip, (jnp.asarray(src[b]), jnp.asarray(trg[b])))
        img1, _, raw1, phi1, phi1s = jeng.labels_to_image_full(k_g1, s, engine_cfg)
        img2, map2 = jeng.labels_to_image(k_g2, t, engine_cfg)
        for name, v in zip(cols, (img1, raw1, phi1, phi1s, img2, map2)):
            cols[name].append(None if v is None else np.asarray(v))
    return {k: (None if v[0] is None else torch.from_numpy(np.stack(v)))
            for k, v in cols.items()}


_BOTH = {}  # case -> result: the Adam test reuses the first case's gradients


def both_sides(tmp_path, **overrides):
    """JAX loss, aux and gradients, and the port's, on one batch and one set
    of weights. Float32 payloads everywhere: the comparison is of the
    algorithm, not of where bfloat16 rounds."""
    key_ = tuple(sorted(overrides.items()))
    if key_ in _BOTH:
        return _BOTH[key_]
    kw = tiny(tmp_path, compose_payload_dtype="", **overrides)
    jcfg, tcfg = JTrainConfig.from_dict(dict(kw)), TrainConfig.from_dict(dict(kw))
    jvcfg = dataclasses.replace(jtr.vxm_config_from(jcfg), integrate_payload_dtype="")
    jecfg = dataclasses.replace(jtr.engine_config_from(jcfg), integrate_payload_dtype="")
    flat = random_flat_params(jvcfg, 31, flow_scale=0.02)
    params = jtr._unflatten_params(jvd.params_template(jvcfg), flat)
    maps = label_maps(4)
    src, trg = maps[:2], maps[2:]
    key = jax.random.PRNGKey(17)

    loss_fn = jtr.make_loss_fn(jvd.VxmDense(cfg=jvcfg), jecfg, jcfg, False)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, key, jnp.asarray(src), jnp.asarray(trg))

    trainer = ttr.Trainer(tcfg, device="cpu")
    trainer.model.payload_dtype = None
    tecfg = dataclasses.replace(trainer.engine_cfg, integrate_payload_dtype="")
    trainer.model.load_state_dict(params_from_jax(flat, trainer.vxm_cfg))
    batch = jax_synthesize(key, src, trg, jecfg)
    trainer.optimizer.zero_grad()
    loss, aux = ttr.loss_from_batch(trainer.model, batch, tecfg, tcfg, False)
    loss.backward()
    _BOTH[key_] = dict(jloss=float(jloss), jaux=jaux, jgrads=jtr._flatten_params(jgrads),
                       params=params, flat=flat, jcfg=jcfg, loss=float(loss.detach()), aux=aux,
                       trainer=trainer)
    return _BOTH[key_]


CASES = {
    "compose2-bridge": dict(compose_res=2, svf_int_res=4),   # k = 2 grid bridge
    "compose2-same-grid": dict(compose_res=2, svf_int_res=2),  # k = 1
    "compose1": dict(compose_res=1, svf_int_res=4),          # full-res compose
    "grad-res2": dict(compose_res=2, svf_int_res=4, grad_res=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_parameter_gradients_equal_jax(tmp_path, case):
    r = both_sides(tmp_path, **CASES[case])
    np.testing.assert_allclose(r["loss"], r["jloss"], atol=1e-5, rtol=1e-5)
    for k in ("dice_loss", "grad_loss"):
        np.testing.assert_allclose(float(r["aux"][k]), float(r["jaux"][k]), atol=1e-5, rtol=1e-4)
    grads = grads_to_jax(r["trainer"].model)
    assert set(grads) == set(r["jgrads"]) and len(grads) == 22
    for name, want in r["jgrads"].items():
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(grads[name], want, rtol=0, atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_one_adam_step_equals_optax(tmp_path):
    r = both_sides(tmp_path, **CASES["compose2-bridge"])
    lr = r["jcfg"].lr
    opt = optax.adam(lr)
    jgrads = jtr._unflatten_params(r["params"], r["jgrads"])
    updates, _ = opt.update(jgrads, opt.init(r["params"]), r["params"])
    want = jtr._flatten_params(optax.apply_updates(r["params"], updates))
    r["trainer"].optimizer.step()
    got = params_to_jax(r["trainer"].model.state_dict())
    for name in want:
        step_got, step_want = got[name] - r["flat"][name], want[name] - r["flat"][name]
        sure = np.abs(r["jgrads"][name]) > 1e-5
        np.testing.assert_allclose(step_got[sure], step_want[sure], atol=1e-3 * lr, err_msg=name)
        # taps that no voxel reaches (dec_0 works on one voxel at 16 cubed)
        # have a zero gradient on both sides and do not move
        dead = r["jgrads"][name] == 0
        assert np.all(step_got[dead] == 0) and np.all(step_want[dead] == 0), name
        assert np.abs(step_got - step_want).max() <= 2 * lr + 1e-9, name
        assert np.abs(step_got).max() > 0.5 * lr, name  # every leaf moved


def test_clip_by_global_norm_is_the_optax_rule():
    rng = np.random.default_rng(3)
    grads = {"a": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    for max_norm in (0.5, 100.0):  # clipping, and below the threshold (unchanged)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
        params = []
        for v in grads.values():
            p = torch.nn.Parameter(torch.zeros(v.shape))
            p.grad = torch.from_numpy(v.copy())
            params.append(p)
        norm = ttr.clip_by_global_norm_(params, max_norm)
        np.testing.assert_allclose(float(norm), np.sqrt(sum((v ** 2).sum() for v in grads.values())),
                                   rtol=1e-6)
        for p, k in zip(params, grads):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
