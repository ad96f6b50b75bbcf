#!/usr/bin/env python3
"""Feed the JAX package's rendered frames to both packages' pipelines.

Separates the pipeline from the renderer when the port's map differs from
the JAX package's on a synthetic config: both pipelines then read the same
frames, through `dataset.kind=directory`.

    # 1. render the config's frames with the JAX package (or, with
    #    --renderer torch, with the port on the CPU) into DirectoryDataset's
    #    layout, and write a config that reads them (everything else as in the
    #    original config)
    python scripts/torch_port_directory.py export --config configs/apartment_synthetic.yaml \
        --out /tmp/apartment_frames [--renderer torch]
    # 2. run both packages on them (the port with --device cpu, or on the card);
    #    the reference in its earliest host-pull schedule, which the port keeps
    python scripts/torch_port_directory.py run-reference --config /tmp/apartment_frames/config.yaml \
        run.output_dir=/tmp/jax_dir
    python -m khronos_tpu_torch.run --device cpu --config /tmp/apartment_frames/config.yaml \
        run.output_dir=/tmp/torch_dir
    # 3. compare the saved maps array by array
    python scripts/torch_port_directory.py compare /tmp/jax_dir /tmp/torch_dir
    # the two renderers on a config's frames: the unit rays' norm (the
    # renderer's first rounding-sensitive step) and the depth, per frame
    python scripts/torch_port_directory.py renderer --config configs/apartment_synthetic.yaml 10 85

Frames are stored as rendered (float32 depth in m, float32 colour, int32
labels, and for an open-set config int32 instances and float32 features);
each pose is written as a quaternion, which both packages turn back
into a float32 rotation with their own quat_to_rot.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), in float64."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def export(config_path: str, out: str, renderer: str = "jax") -> None:
    with open(config_path) as fh:
        config = yaml.safe_load(fh)
    spec = dict(config["dataset"])
    if spec.pop("kind", "synthetic") != "synthetic":
        raise SystemExit("export needs a synthetic config")
    if renderer == "jax":
        from khronos_tpu.data.datasets import SyntheticDataset

        ds = SyntheticDataset(**spec)
    else:
        from khronos_tpu_torch.data.datasets import SyntheticDataset

        ds = SyntheticDataset(device="cpu", **spec)
    cam = ds.camera
    os.makedirs(os.path.join(out, "frames"), exist_ok=True)
    with open(os.path.join(out, "intrinsics.json"), "w") as fh:
        json.dump({"height": cam.height, "width": cam.width, "fx": cam.fx, "fy": cam.fy, "cx": cam.cx,
                   "cy": cam.cy, "min_range": cam.min_range, "max_range": cam.max_range, "depth_scale": 1.0}, fh)
    rows = []
    for frame, _ in ds:
        stamp = int(frame.stamp_ns)
        arrays = {"depth": np.asarray(frame.depth, np.float32), "color": np.asarray(frame.color, np.float32),
                  "labels": np.asarray(frame.labels, np.int32)}
        if frame.instances is not None:
            arrays["instances"] = np.asarray(frame.instances, np.int32)
        if frame.label_features is not None:
            arrays["features"] = np.asarray(frame.label_features, np.float32)
        np.savez(os.path.join(out, "frames", f"{stamp}.npz"), **arrays)
        q = rot_to_quat_wxyz(frame.R_w_c)
        t = np.asarray(frame.t_w_c, np.float64)
        rows.append(",".join([str(stamp)] + [repr(float(x)) for x in (*t, *q)]))
    with open(os.path.join(out, "poses.csv"), "w") as fh:
        fh.write("stamp_ns,tx,ty,tz,qw,qx,qy,qz\n" + "\n".join(rows) + "\n")
    config["dataset"] = {"kind": "directory", "root": os.path.abspath(out)}
    config.setdefault("run", {})["evaluate"] = False
    with open(os.path.join(out, "config.yaml"), "w") as fh:
        yaml.safe_dump(config, fh)
    print(f"{len(rows)} frames of {cam.height}x{cam.width} ({renderer} renderer) -> {out}; "
          f"config {os.path.join(out, 'config.yaml')}")


def run_reference(argv) -> str:
    """`python -m khronos_tpu.run` with every host pull of the reference
    waited for as it is started (its earliest schedule; the port's on the
    CPU, as tests/test_torch_bus.py forces it)."""
    import jax

    from khronos_tpu import run as jrun
    from khronos_tpu.active_window import active_window as jaw
    from khronos_tpu.map import meshing as jmeshing

    concat, body, extract = jaw._bus_concat, jmeshing.start_body_pull, jmeshing.extract_mesh_async
    jaw._bus_concat = lambda *xs: jax.block_until_ready(concat(*xs))
    jmeshing.start_body_pull = lambda *a: jax.block_until_ready(body(*a))
    jmeshing.extract_mesh_async = lambda *a, **k: jax.block_until_ready(extract(*a, **k))
    return jrun.main(argv)


def renderer(config_path: str, frames) -> None:
    """Per frame: the share of pixels whose unit-ray norm and whose depth
    differ between the reference's compiled renderer and the port's, and the
    largest depth difference (m). The reference's intermediate comes from a
    copy of its `_render` that also returns the norm."""
    import inspect

    import jax.numpy as jnp

    from khronos_tpu.data import synthetic as jsyn
    from khronos_tpu.data.datasets import SyntheticDataset as JDataset
    from khronos_tpu_torch import fma32, sqrt32
    from khronos_tpu_torch.data import synthetic as tsyn
    from khronos_tpu_torch.data.datasets import SyntheticDataset as TDataset

    with open(config_path) as fh:
        spec = dict(yaml.safe_load(fh)["dataset"])
    spec.pop("kind", None)
    jseq, tseq = JDataset(**spec).seq, TDataset(device="cpu", **spec).seq
    src = inspect.getsource(jsyn._render).replace(
        "    return depth, label_img, color_img, hit_prim, hit_ok",
        "    return depth, label_img, color_img, hit_prim, hit_ok, norms")
    ns = dict(vars(jsyn))
    exec(src, ns)
    cfg = jseq.config
    for i in frames:
        t = i / cfg.fps
        R, pos = jseq.pose_at(t)
        out = ns["_render"](*jseq.scene.device_arrays(t), jseq._rays, jnp.asarray(R), jnp.asarray(pos),
                            jnp.float32(cfg.max_range), cfg.height, cfg.width)
        depth, norms = np.asarray(out[0]), np.asarray(out[5])[..., 0]
        dirs = tsyn.rotate_rays(tseq.camera.pixel_rays("cpu"), R)
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        tnorm = sqrt32(fma32(z, z, fma32(y, y, x * x))).numpy()
        tdepth = tseq.render_frame(i)["depth"].numpy()
        print(json.dumps({"frame": i, "norm_differs": float((tnorm != norms).mean()),
                          "depth_differs": float((tdepth != depth).mean()),
                          "depth_max_diff_m": float(np.abs(tdepth - depth).max())}))


def compare(a_dir: str, b_dir: str) -> int:
    """Report every array of final.4dmap.npz and dsg.npz that differs."""
    differ = 0
    for name in ("final.4dmap.npz", "dsg.npz"):
        a = np.load(os.path.join(a_dir, name), allow_pickle=True)
        b = np.load(os.path.join(b_dir, name), allow_pickle=True)
        for key in sorted(set(a.files) | set(b.files)):
            if key not in a.files or key not in b.files:
                print(f"{name}:{key}: only in {'the first' if key in a.files else 'the second'}")
                differ += 1
                continue
            x, y = a[key], b[key]
            if x.shape != y.shape:
                print(f"{name}:{key}: shapes {x.shape} vs {y.shape}")
                differ += 1
            elif not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                n = int((x != y).sum())
                dmax = float(np.nanmax(np.abs(x.astype(np.float64) - y))) if x.dtype.kind in "fiu" else None
                print(f"{name}:{key}: {n} of {x.size} entries differ (max {dmax})")
                differ += 1
    print(f"{differ} arrays differ")
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="render a synthetic config's frames into DirectoryDataset's layout")
    ex.add_argument("--config", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--renderer", choices=("jax", "torch"), default="jax",
                    help="render with the JAX package (default) or with the port on the CPU")
    sub.add_parser("run-reference", help="python -m khronos_tpu.run's arguments, in its earliest schedule")
    rnd = sub.add_parser("renderer", help="the two renderers on a synthetic config's frames")
    rnd.add_argument("--config", required=True)
    rnd.add_argument("frames", type=int, nargs="+")
    cmp_ = sub.add_parser("compare", help="compare two runs' final.4dmap.npz and dsg.npz")
    cmp_.add_argument("a")
    cmp_.add_argument("b")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run-reference"]:
        run_reference(argv[1:])
        return 0
    args = ap.parse_args(argv)
    if args.cmd == "export":
        export(args.config, args.out, args.renderer)
        return 0
    if args.cmd == "renderer":
        renderer(args.config, args.frames)
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
