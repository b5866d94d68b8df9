"""The JAX package's synthesis draws, as the port's ``render`` takes them.

``deepcharuco_tpu.data.device_synth`` draws inside its per-sample
functions from a ``PRNGKey`` by a fixed ``split``/``fold_in`` sequence. The
functions here repeat that sequence, draw the same numbers, and arrange them
in the nested dicts of ``deepcharuco_tpu_torch.data.device_synth`` (a
leading batch dimension, numpy arrays), so that the port renders exactly
the samples the JAX package renders from the same keys. Used by the tests
and by ``scripts/make_torch_port_fixture.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U = jax.random.uniform


def _affine(key, scale_range, translate_frac, axis_snap_p):
    ks = jax.random.split(key, 7)
    d = {"s": U(ks[0], (), minval=scale_range[0], maxval=scale_range[1]),
         "ang": U(ks[1], (), minval=-2 * jnp.pi, maxval=2 * jnp.pi),
         "sh_deg": U(ks[2], (2,), minval=-35.0, maxval=35.0),
         "t_frac": U(ks[3], (2,), minval=translate_frac[0], maxval=translate_frac[1]),
         "snap": jnp.asarray(False), "snap_jitter": jnp.float32(0.0)}
    if axis_snap_p > 0.0:
        d["snap"] = U(ks[5]) < axis_snap_p
        d["snap_jitter"] = U(ks[6], (), minval=-0.035, maxval=0.035)
    return d


def _bg(key, hw):
    h, w = hw
    ks = jax.random.split(key, 6)
    blobs = [jax.random.split(ks[1 + i], 4) for i in range(2)]
    return {"corners": U(ks[0], (2, 2), minval=0.0, maxval=255.0),
            "cx": jnp.stack([U(kk[0], (), minval=0.0, maxval=w) for kk in blobs]),
            "cy": jnp.stack([U(kk[1], (), minval=0.0, maxval=h) for kk in blobs]),
            "r": jnp.stack([U(kk[2], (), minval=h / 8.0, maxval=h / 2.0) for kk in blobs]),
            "col": jnp.stack([U(kk[3], (), minval=0.0, maxval=255.0) for kk in blobs]),
            "sigma": U(ks[4], (), minval=2.0, maxval=12.0),
            "noise": jax.random.normal(ks[5], (h, w))}


def _bank(key_bg, bank_shape, hw, p):
    nb, hb, wb = bank_shape
    h, w = hw
    ks = jax.random.split(jax.random.fold_in(key_bg, 101), 5)
    return {"use": U(jax.random.fold_in(key_bg, 102)) < p,
            "idx": jax.random.randint(ks[0], (), 0, nb),
            "theta": U(ks[1], (), minval=-jnp.pi, maxval=jnp.pi),
            "flip": jax.random.randint(ks[2], (2,), 0, 2) * 2 - 1,
            "cx": U(ks[3], (), minval=0.4 * w, maxval=wb - 0.4 * w),
            "cy": U(ks[4], (), minval=0.4 * h, maxval=hb - 0.4 * h)}


def _hole(key, p):
    ks = jax.random.split(key, 4)
    return {"apply": U(ks[0]) < p,
            "n_holes": jax.random.randint(ks[1], (), 1, 7),
            "sizes": jax.random.randint(ks[2], (6, 2), 16, 65),
            "pos": U(ks[3], (6, 2))}


def _photo(key, hw, low_gain_p=0.0, low_gain_range=(0.08, 0.6)):
    ks = jax.random.split(key, 8)
    kb = jax.random.fold_in(key, 7)
    d = {"contrast_on": U(ks[0]) < 0.5,
         "contrast": U(ks[1], (), minval=0.8, maxval=1.2),
         "noise_on": U(ks[2]) < 0.5,
         "noise_var": U(ks[3], (), minval=10.0, maxval=50.0),
         "noise": jax.random.normal(ks[4], hw),
         "mult_on": U(ks[5]) < 0.5,
         "mult": U(ks[6], (), minval=0.95, maxval=1.05),
         "bright_on": U(ks[7]) < 0.5,
         "bright": U(jax.random.fold_in(key, 99), (), minval=-0.8, maxval=0.35),
         "blur_on": U(kb) < 0.6,
         "blur": U(jax.random.fold_in(kb, 1), (), minval=0.3, maxval=1.0)}
    if low_gain_p > 0.0:
        kg = jax.random.fold_in(key, 23)
        d.update({"gain_on": U(jax.random.fold_in(kg, 1)) < low_gain_p,
                  "gain": U(kg, (), minval=low_gain_range[0], maxval=low_gain_range[1]),
                  "read_sigma": U(jax.random.fold_in(kg, 2), (), minval=1.0, maxval=6.0),
                  "dark_noise": jax.random.normal(jax.random.fold_in(kg, 3), hw)})
    return d


def _detector_sample(synth, key):
    """One sample's draws of a JAX ``DeviceSynthesizer`` (``_sample_full``)."""
    ks = jax.random.split(key, 6)
    if synth.perspective_p > 0.0:
        kp = jax.random.fold_in(ks[0], 7)
        on = U(jax.random.fold_in(kp, 1)) < synth.perspective_p
        pv = jnp.where(on, U(kp, (2,), minval=-8e-4, maxval=8e-4), 0.0)
    else:
        pv = jnp.zeros(2, jnp.float32)
    d = {"affine": _affine(ks[0], synth.scale_range, synth.translate_frac,
                           synth.axis_snap_p),
         "pv": pv,
         "bg": _bg(ks[1], synth.hw),
         "hole": _hole(ks[2], synth.dropout_p),
         "negative": U(ks[3]) < synth.negative_p,
         "photo": _photo(ks[4], synth.hw, synth.low_gain_p, (synth.low_gain_min, 0.6)),
         "perm": jax.random.permutation(ks[5], synth.n_ids)}
    if synth.bg_bank is not None:
        d["bank"] = _bank(ks[1], synth.bg_bank.shape, synth.hw, synth.bg_bank_p)
    return d


def _frame_patch_sample(synth, key):
    ks = jax.random.split(key, 3)
    return {"frame": _detector_sample(synth.inner, ks[0]),
            "pick": U(ks[1], (synth.per_frame, synth.n_ids)),
            "jitter": U(ks[2], (synth.per_frame, 2), minval=-synth.jitter,
                        maxval=synth.jitter)}


def _refine_sample(synth, key):
    ks = jax.random.split(key, 5)
    ps = (synth.patch_size, synth.patch_size)
    return {"affine": _affine(ks[0], synth.inner.scale_range, synth.inner.translate_frac, 0.0),
            "idx": jax.random.randint(ks[1], (), 0, synth.n_ids),
            "off": U(ks[2], (2,), minval=-3.99, maxval=3.99),
            "bg": _bg(ks[3], ps),
            "photo": _photo(ks[4], ps)}


def _stack(samples):
    if isinstance(samples[0], dict):
        return {k: _stack([s[k] for s in samples]) for k in samples[0]}
    return np.stack([np.asarray(s) for s in samples])


def draws(synth, key, n: int):
    """The draws of ``synth.batch(key, n)`` for a JAX ``DeviceSynthesizer``,
    ``FramePatchSynthesizer`` or ``DeviceRefineSynthesizer``."""
    kind = type(synth).__name__
    if kind == "FramePatchSynthesizer":
        frames = max(1, n // synth.per_frame)
        return _stack([_frame_patch_sample(synth, k) for k in jax.random.split(key, frames)])
    one = _refine_sample if kind == "DeviceRefineSynthesizer" else _detector_sample
    return _stack([one(synth, k) for k in jax.random.split(key, n)])
