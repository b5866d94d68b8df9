"""Write tests/data/torch_port_frames.npz: frames and the JAX package's
outputs on them, for checking the PyTorch/CUDA port where JAX is absent.

The frames are 8 uint8 gray 240×320 synthetic board views
(``DeviceSynthesizer(default_config()).batch(PRNGKey(2024), 8)``, mapped
back to uint8 with ``clip(rint(g·255 + 128))``). Stored outputs, all from
``deepcharuco_tpu`` on the CPU with the shipped weights on those uint8
frames:

- ``{keypoints,valid,refined}_bf16``: ``two_stage_forward`` with bf16
  models, as ``bench.py`` builds them;
- ``{keypoints,valid,refined}_f32``: the same with float32 models, as
  ``tests/test_golden.py`` builds them;
- ``{keypoints,valid}_fused``: the bf16 trunk → ``pallas_fused_head_decode``
  (interpret mode), the composition of ``cli/benchmark.py --fused-head``;
- ``K``, ``dist``: a fixed camera for the 240×320 frames, and
  ``{ok,rvec,tvec,rms}_{bf16,f32}``: the pose outputs of ``full_forward``
  under it (its corner outputs are the arrays above);
- ``{keypoints,valid,refined}_top4``: ``two_stage_forward`` with
  ``decode_capacity=4``, bf16;
- ``frames_hi``: 4 uint8 gray 480×640 views from the same synthesizer at
  twice the resolution (``scaled_config(cfg, 2)``, ``PRNGKey(2025)``),
  ``K_hi``: the camera at that resolution, and
  ``{keypoints,valid,refined,ok,rvec,tvec,rms}_hires_{bf16,f32}``:
  ``full_forward_hires`` at scale 2 with the 32-px RefineNet
  (``artifacts/refinenet32_devsynth.npz``), the soft decode and
  ``Camera(K_hi, dist).scaled(0.5)``;
- ``rn_offset/...``: an offset branch (``convOa``, ``denseOa``,
  ``denseOb``) from a seeded Flax ``init`` (``PRNGKey(7)``), stored as
  float16 under '/'-joined variable paths, and ``refined_{offset,avg}_{bf16,f32}``:
  ``two_stage_forward`` with that branch (cast back to float32) on top of the
  shipped 24-px weights and ``rn_decode="offset"``/``"avg"``;
- ``geom_noise_g`` (32, 16), ``geom_noise_gs`` (32, 16, 5): the Gumbel
  tables that ``ops.geom._ransac_seed`` draws from ``PRNGKey(0)`` for 32
  subsets of 16 ids × 5 candidate slots (they do not depend on the frames);
- ``{keypoints,valid,refined,filled,ok,rvec,tvec,rms}_{geom,geomfill}_{bf16,f32}``:
  ``full_forward`` with ``geom_board_xy`` (and ``geom_fill``), 24-px hard
  decode, with ``filled`` from ``two_stage_forward(return_filled=True)``;
  ``..._hires_{geom,geomfill}_{bf16,f32}``: ``full_forward_hires`` at scale
  2 on ``frames_hi`` with the same options (32-px RefineNet, soft decode);
- ``{keypoints,valid,refined}_int8``: ``load_pipeline`` on the shipped int8
  detector (``artifacts/detector_devsynth_int8.npz``) with the bf16 24-px
  RefineNet, ``detect`` on the frames;
- ``synth/<name>/draw/...``: the draws of four synthesis batches, in the
  port's layout (``tests/_jax_synth_draws.py``; '/'-joined paths), and
  ``synth/<name>/out/...`` what the JAX synthesiser renders from them:
  ``det_base`` (``DeviceSynthesizer``, ``PRNGKey(31)``, 4 samples; images,
  ``loc``, ``ids``, ``kpts``, ``visible``), ``det_diet`` (the same with
  ``perspective_p``, ``axis_snap_p`` and ``low_gain_p`` at 0.5,
  ``PRNGKey(33)``: each of the three on in two of the four samples),
  ``frame_patch`` (``FramePatchSynthesizer`` with ``perspective_p=0.5``,
  ``PRNGKey(37)``, 8 patches from one frame; patches, heatmaps) and ``refine`` (``DeviceRefineSynthesizer``,
  ``PRNGKey(34)``, 8 patches). To halve the file, every normal field is
  drawn rounded to float16, in the stored draws and in the JAX render alike
  (``jax.random.normal`` is wrapped while these are made), fields a sample
  does not use (noise switched off, no low gain) are stored as zeros, and
  the images are stored as float16;
- ``train/det/...``: three float32 Adam steps (``optax.adam(1e-4)``,
  ``make_detector_train_step``) from the shipped detector weights on the 8
  synthesized frames of ``det_base`` and ``det_diet`` (their stored float16
  images and label maps): ``loss``, ``loss_loc``, ``loss_ids`` per step and
  the running statistics after the third (``batch_stats/...``);
  ``train/rn/...``: the same for the shipped 24-px RefineNet
  (``optax.adam(1e-4)``) on the ``refine`` patches and heatmaps. The
  learning rate is kept small because the shipped weights are close to a
  minimum: at 5e-3 the second step's loss already differs by 4e-4 between
  two float32 runs and from float64 (Adam steps every parameter by about
  the learning rate whatever its gradient, so the gradients' rounding
  decides the next loss).
- ``eval/...``: the JAX package's evaluation (``cli/eval.py``'s forward:
  float32 detector, ``pred_to_keypoints``, the 24-px RefineNet with the
  hard decode, shipped weights) on the 4 stored ``det_base`` images against
  their sub-pixel truth (``kpts``, ``visible``), ``--px-margin 3``:
  ``keypoints``, ``valid``, ``refined`` and ``n_target``, ``n_pred``,
  ``n_matched``, ``raw_mean``, ``refined_mean``.

Run from the repository root: ``python scripts/make_torch_port_fixture.py``.
The file is regenerated only by this script.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from deepcharuco_tpu.board import inner_corner_object_points  # noqa: E402
from deepcharuco_tpu.configs import default_config, scaled_config  # noqa: E402
from deepcharuco_tpu.data.device_synth import (DeviceRefineSynthesizer,  # noqa: E402
                                               DeviceSynthesizer, FramePatchSynthesizer)
from deepcharuco_tpu.models import Detector, RefineNet  # noqa: E402
from deepcharuco_tpu.ops import normalize_gray  # noqa: E402
from deepcharuco_tpu.ops.pallas_fused import (fold_head_params,  # noqa: E402
                                              pallas_fused_head_decode)
from deepcharuco_tpu.pipeline import (Camera, full_forward, full_forward_hires,  # noqa: E402
                                      load_pipeline, two_stage_forward,
                                      two_stage_forward_hires, variables_from_npz)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))
import _jax_synth_draws  # noqa: E402

OUT = os.path.join("tests", "data", "torch_port_frames.npz")
DET = "artifacts/detector_devsynth.npz"
RN = "artifacts/refinenet_devsynth.npz"
RN32 = "artifacts/refinenet32_devsynth.npz"
DET_INT8 = "artifacts/detector_devsynth_int8.npz"
K = np.array([[420.0, 0.0, 160.0], [0.0, 420.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
K_HI = np.array([[840.0, 0.0, 320.0], [0.0, 840.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
DIST = np.array([0.05, -0.02, 0.001, -0.0015, 0.01], np.float32)
OBJ = inner_corner_object_points(5, 5, 0.01)
POSE_KEYS = ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "rms")
GEOM_KEYS = POSE_KEYS + ("filled",)
OFFSET_LAYERS = ("convOa", "denseOa", "denseOb")


def _to_uint8(imgs) -> np.ndarray:
    g = np.asarray(imgs)[..., 0]
    return np.clip(np.rint(g * 255.0 + 128.0), 0, 255).astype(np.uint8)


def frames(n: int = 8) -> np.ndarray:
    imgs, _, _ = DeviceSynthesizer(default_config()).batch(jax.random.PRNGKey(2024), n)
    return _to_uint8(imgs)


def frames_hi(n: int = 4) -> np.ndarray:
    cfg = scaled_config(default_config(), 2)
    imgs, _, _ = DeviceSynthesizer(cfg).batch(jax.random.PRNGKey(2025), n)
    return _to_uint8(imgs)


def jax_outputs(x: np.ndarray, dtype) -> dict:
    """``full_forward`` (24-px hard decode) under the fixed camera."""
    det, rn = Detector(n_ids=16, dtype=dtype), RefineNet(dtype=dtype)
    dv, rv = variables_from_npz(DET), variables_from_npz(RN)
    out = jax.jit(lambda dv, rv, x: full_forward(
        det, rn, dv, rv, x, 16, jnp.asarray(OBJ), jnp.asarray(K), jnp.asarray(DIST)))(
        dv, rv, x)
    return dict(zip(POSE_KEYS, (np.asarray(o) for o in out)))


def jax_hires(x_hi: np.ndarray, dtype) -> dict:
    det, rn = Detector(n_ids=16, dtype=dtype), RefineNet(dtype=dtype, patch_size=32)
    dv, rv = variables_from_npz(DET), variables_from_npz(RN32)
    cam = Camera(K=K_HI, dist=DIST).scaled(0.5)
    out = jax.jit(lambda dv, rv, x: full_forward_hires(
        det, rn, dv, rv, x, 16, jnp.asarray(OBJ), jnp.asarray(cam.K),
        jnp.asarray(cam.dist), rn_decode="soft", scale=2))(dv, rv, x_hi)
    return dict(zip(POSE_KEYS, (np.asarray(o) for o in out)))


def jax_top4(x: np.ndarray) -> dict:
    det, rn = Detector(n_ids=16), RefineNet()
    dv, rv = variables_from_npz(DET), variables_from_npz(RN)
    out = jax.jit(lambda dv, rv, x: two_stage_forward(
        det, rn, dv, rv, x, 16, decode_capacity=4))(dv, rv, x)
    return dict(zip(POSE_KEYS, (np.asarray(o) for o in out)))


def offset_branch() -> dict:
    """A seeded offset branch as flat float16 arrays (half the bytes; the
    float16 values are the weights)."""
    v = RefineNet(dtype=jnp.float32, offset_head=True).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 24, 24, 1), jnp.float32))
    flat = {}
    for coll in ("params", "batch_stats"):
        for layer in OFFSET_LAYERS:
            if layer in v[coll]:
                for kp, leaf in jax.tree_util.tree_flatten_with_path(v[coll][layer])[0]:
                    key = "/".join([coll, layer] + [k.key for k in kp])
                    flat[key] = np.asarray(leaf).astype(np.float16)
    return flat


def with_offset_branch(rv: dict, flat: dict) -> dict:
    """The shipped 24-px variables plus the stored branch, as float32."""
    out = {coll: dict(rv[coll]) for coll in rv}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.astype(np.float32)
    return out


def jax_offset(x: np.ndarray, flat: dict, dtype) -> dict:
    det, rn = Detector(n_ids=16, dtype=dtype), RefineNet(dtype=dtype, offset_head=True)
    dv = variables_from_npz(DET)
    rv = with_offset_branch(variables_from_npz(RN), flat)
    out = {}
    for mode in ("offset", "avg"):
        _, _, refined = jax.jit(lambda dv, rv, x: two_stage_forward(
            det, rn, dv, rv, x, 16, rn_decode=mode))(dv, rv, x)
        out[mode] = np.asarray(refined)
    return out


def geom_noise(n_subsets: int = 32, n_ids: int = 16, capacity: int = 5):
    """The two Gumbel tables of ``ops.geom._ransac_seed``, drawn as it
    draws them: (g (S, n_ids), gs (S, n_ids, C))."""
    def draw(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.gumbel(k1, (n_ids,)),
                jax.random.gumbel(k2, (n_ids, capacity)))

    g, gs = jax.vmap(draw)(jax.random.split(jax.random.PRNGKey(0), n_subsets))
    return np.asarray(g), np.asarray(gs)


def jax_geom(x: np.ndarray, dtype, fill: bool, hires: bool) -> dict:
    """The pose path under the geometry decode, plus the ``filled`` mask."""
    det = Detector(n_ids=16, dtype=dtype)
    dv = variables_from_npz(DET)
    xy = jnp.asarray(OBJ[:, :2])
    if hires:
        rn, rv = RefineNet(dtype=dtype, patch_size=32), variables_from_npz(RN32)
        cam = Camera(K=K_HI, dist=DIST).scaled(0.5)
        kw = dict(rn_decode="soft", geom_board_xy=xy, geom_fill=fill, scale=2)

        def fn(dv, rv, x):
            return (*full_forward_hires(det, rn, dv, rv, x, 16, jnp.asarray(OBJ),
                                        jnp.asarray(cam.K), jnp.asarray(cam.dist), **kw),
                    two_stage_forward_hires(det, rn, dv, rv, x, 16, return_filled=True,
                                            **kw)[3])
    else:
        rn, rv = RefineNet(dtype=dtype), variables_from_npz(RN)
        kw = dict(geom_board_xy=xy, geom_fill=fill)

        def fn(dv, rv, x):
            return (*full_forward(det, rn, dv, rv, x, 16, jnp.asarray(OBJ), jnp.asarray(K),
                                  jnp.asarray(DIST), **kw),
                    two_stage_forward(det, rn, dv, rv, x, 16, return_filled=True, **kw)[3])
    return dict(zip(GEOM_KEYS, (np.asarray(o) for o in jax.jit(fn)(dv, rv, x))))


def jax_int8(x: np.ndarray) -> dict:
    out = load_pipeline(default_config(), DET_INT8, RN).detect(x)
    return dict(zip(POSE_KEYS, (np.asarray(o) for o in out)))


def jax_fused(x: np.ndarray) -> dict:
    det = Detector(n_ids=16)
    dv = variables_from_npz(DET)
    folded = fold_head_params(dv, 16)
    trunk = det.apply(dv, normalize_gray(jnp.asarray(x)), trunk_only=True)["trunk"]
    kp, valid = pallas_fused_head_decode(trunk, folded, 16, interpret=True)
    return {"keypoints": np.asarray(kp), "valid": np.asarray(valid)}


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def synth_batches() -> dict:
    """The synthesis draws and JAX renders (``synth/...``), the normal
    fields rounded to float16 throughout."""
    normal = jax.random.normal

    def normal16(*a, **kw):
        return normal(*a, **kw).astype(jnp.float16).astype(jnp.float32)

    cfg = default_config()
    batches = {
        "det_base": (DeviceSynthesizer(cfg), 31, 4),
        "det_diet": (DeviceSynthesizer(cfg, perspective_p=0.5, axis_snap_p=0.5,
                                       low_gain_p=0.5), 33, 4),
        "frame_patch": (FramePatchSynthesizer(cfg, perspective_p=0.5), 37, 8),
        "refine": (DeviceRefineSynthesizer(cfg), 34, 8),
    }
    out = {}
    jax.random.normal = normal16
    try:
        for name, (synth, seed, n) in batches.items():
            key = jax.random.PRNGKey(seed)
            d = _jax_synth_draws.draws(synth, key, n)
            if name.startswith("det"):
                res = jax.vmap(synth._sample_full)(jax.random.split(key, n))
                keys = ("images", "loc", "ids", "kpts", "visible")
            else:
                res = synth.batch(key, n)
                keys = ("patches", "heatmaps")
            res = dict(zip(keys, (np.asarray(r) for r in res)))
            if "images" in res:
                res["images"] = res["images"].astype(np.float16)
            photo = d["frame"]["photo"] if name == "frame_patch" else d["photo"]
            photo["noise"] = photo["noise"] * photo["noise_on"][:, None, None]
            if "dark_noise" in photo:
                photo["dark_noise"] = photo["dark_noise"] * photo["gain_on"][:, None, None]
            flat = _flat(d, f"synth/{name}/draw")
            for k, v in flat.items():
                if v.dtype == np.float32 and v.ndim == 3:      # the (B, H, W) normal fields
                    flat[k] = v.astype(np.float16)
            out.update(flat)
            out.update(_flat(res, f"synth/{name}/out"))
    finally:
        jax.random.normal = normal
    return out


def train_steps(images, a, b, model, variables, lr, loss_keys) -> dict:
    """Three float32 Adam steps on one batch: each step's losses and the
    running statistics after the third."""
    import optax

    from deepcharuco_tpu.train import (create_detector_state, create_refinenet_state,
                                       make_detector_train_step, make_refinenet_train_step)

    tx = optax.adam(lr)
    if isinstance(model, Detector):
        _, state = create_detector_state(model, jax.random.PRNGKey(0), tx=tx)
        step = jax.jit(make_detector_train_step(model, tx))
    else:
        _, state = create_refinenet_state(model, jax.random.PRNGKey(0), tx=tx)
        step = jax.jit(make_refinenet_train_step(model, tx))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    losses = {k: [] for k in loss_keys}
    for _ in range(3):
        state, aux = step(state, images, a, b) if b is not None else step(state, images, a)
        for k in loss_keys:
            losses[k].append(float(aux[k]))
    out = {k: np.asarray(v, np.float32) for k, v in losses.items()}
    out.update(_flat(jax.tree.map(np.asarray, state.batch_stats), "batch_stats"))
    return out


def jax_eval(out: dict) -> dict:
    """``cli/eval.py``'s forward and figures on the stored ``det_base`` renders."""
    from deepcharuco_tpu.ops import extract_patches, pred_to_keypoints, refine_keypoints

    det, rn = Detector(n_ids=16, dtype=jnp.float32), RefineNet(dtype=jnp.float32)
    dv, rv = variables_from_npz(DET), variables_from_npz(RN)
    images = jnp.asarray(out["synth/det_base/out/images"].astype(np.float32))
    o = det.apply(dv, images)
    kp, valid = pred_to_keypoints(o["loc"], o["ids"], 16)
    patches = extract_patches(images, kp, patch_size=24)
    n, k, p, _ = patches.shape
    heat = rn.apply(rv, patches.reshape(n * k, p, p, 1)).reshape(n, k, 64, 64)
    refined = refine_keypoints(heat, kp)
    kp, valid, refined = np.asarray(kp), np.asarray(valid), np.asarray(refined)
    kt, vt = out["synth/det_base/out/kpts"], out["synth/det_base/out/visible"]
    both = valid & vt
    d_raw = np.linalg.norm(kp - kt, axis=-1)[both]
    d_ref = np.linalg.norm(refined - kt, axis=-1)[both]
    return {"eval/keypoints": kp, "eval/valid": valid, "eval/refined": refined,
            "eval/n_target": np.int64(vt.sum()), "eval/n_pred": np.int64(valid.sum()),
            "eval/n_matched": np.int64((d_raw < 3.0).sum()),
            "eval/raw_mean": np.float64(d_raw.mean()),
            "eval/refined_mean": np.float64(d_ref.mean())}


def main():
    x, x_hi = frames(), frames_hi()
    out = {"frames": x, "frames_hi": x_hi, "K": K, "K_hi": K_HI, "dist": DIST}
    for tag, res in (("bf16", jax_outputs(x, jnp.bfloat16)),
                     ("f32", jax_outputs(x, jnp.float32)),
                     ("fused", jax_fused(x)),
                     ("top4", jax_top4(x)),
                     ("hires_bf16", jax_hires(x_hi, jnp.bfloat16)),
                     ("hires_f32", jax_hires(x_hi, jnp.float32))):
        for k, v in res.items():
            out[f"{k}_{tag}"] = v
    branch = offset_branch()
    out.update({f"rn_offset/{k}": v for k, v in branch.items()})
    for tag, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        for mode, refined in jax_offset(x, branch, dtype).items():
            out[f"refined_{mode}_{tag}"] = refined
    out["geom_noise_g"], out["geom_noise_gs"] = geom_noise()
    for tag, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        for name, fill in (("geom", False), ("geomfill", True)):
            for prefix, frames_in, hires in (("", x, False), ("hires_", x_hi, True)):
                for k, v in jax_geom(frames_in, dtype, fill, hires).items():
                    out[f"{k}_{prefix}{name}_{tag}"] = v
    for k, v in jax_int8(x).items():
        out[f"{k}_int8"] = v
    out.update(synth_batches())
    batch = [np.concatenate([out[f"synth/{n}/out/{k}"] for n in ("det_base", "det_diet")])
             for k in ("images", "loc", "ids")]
    det = train_steps(jnp.asarray(batch[0].astype(np.float32)), jnp.asarray(batch[1]),
                      jnp.asarray(batch[2]), Detector(n_ids=16, dtype=jnp.float32),
                      variables_from_npz(DET), 1e-4, ("loss", "loss_loc", "loss_ids"))
    out.update(_flat(det, "train/det"))
    rn = train_steps(jnp.asarray(out["synth/refine/out/patches"]),
                     jnp.asarray(out["synth/refine/out/heatmaps"]), None,
                     RefineNet(dtype=jnp.float32), variables_from_npz(RN), 1e-4, ("loss",))
    out.update(_flat(rn, "train/rn"))
    out.update(jax_eval(out))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(OUT, os.path.getsize(OUT), "bytes;",
          {k: int(out[f"valid_{k}"].sum())
           for k in ("bf16", "f32", "fused", "top4", "hires_bf16", "hires_f32", "int8",
                     "geom_bf16", "geomfill_bf16", "hires_geom_bf16",
                     "hires_geomfill_bf16")},
          "valid slots;",
          {k: int(out[f"filled_{k}"].sum())
           for k in ("geomfill_bf16", "geomfill_f32", "hires_geomfill_bf16",
                     "hires_geomfill_f32")}, "filled slots;",
          {k: (int(out[f"ok_{k}"].sum()), np.round(out[f"rms_{k}"], 2).tolist())
           for k in ("bf16", "f32", "hires_bf16", "hires_f32")}, "ok frames, rms;",
          "train losses", out["train/det/loss"].tolist(), out["train/rn/loss"].tolist())


if __name__ == "__main__":
    main()
