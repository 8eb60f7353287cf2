"""Command-line entry point.

Flag-compatible with the reference binary
(`PointCloudProcessor/src/main.cpp:11-20`:
--point_cloud_path/--odometry_path/--images_folder/--mask_image_folder/
--output_path/--enableMLS/--enableNIDOptimize), plus a JSON config file for
everything the reference hardcodes in source.
"""

from __future__ import annotations

import argparse
import json
import sys

from .utils.config import PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pcp-tpu",
        description="LiDAR-camera colorization + NID pose refinement on JAX",
    )
    p.add_argument("--config", default="", help="JSON PipelineConfig (overridden by flags)")
    p.add_argument("--point_cloud_path", default=None)
    p.add_argument("--odometry_path", default=None)
    p.add_argument("--images_folder", default=None)
    p.add_argument("--mask_image_folder", default=None)
    p.add_argument("--output_path", default=None)
    p.add_argument("--enableMLS", action="store_true", default=None)
    p.add_argument("--enableNIDOptimize", action="store_true", default=None)
    p.add_argument(
        "--enableInitialGuessManual", action="store_true", default=None,
        help="estimate per-keyframe poses from picked 2D-3D correspondences "
        "(the reference's GUI path, `src/main.cpp:11-20`; here the picks "
        "arrive via --correspondences JSON from tools.pick_tool)",
    )
    p.add_argument(
        "--correspondences", default=None, metavar="PICKS_JSON",
        help="picked 2D-3D correspondence JSON for --enableInitialGuessManual "
        "(schema: pipeline/manual_guess.py; produced by tools.pick_tool)",
    )
    p.add_argument(
        "--resume", action="store_true", default=None,
        help="reuse existing stage artifacts (scans-crop[_mls].pcd, "
        "nid_correction.json) instead of recomputing",
    )
    p.add_argument(
        "--profile-trace-dir", default=None,
        help="capture a JAX/XLA profiler trace of the run into this directory",
    )
    p.add_argument("--dump-config", action="store_true", help="print effective config and exit")
    p.add_argument("--platform", default="", help="force jax platform (e.g. cpu)")
    return p


def config_from_args(args) -> PipelineConfig:
    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
    else:
        cfg = PipelineConfig()
    overrides = {
        "point_cloud_path": args.point_cloud_path,
        "odometry_path": args.odometry_path,
        "images_folder": args.images_folder,
        "mask_image_folder": args.mask_image_folder,
        "output_path": args.output_path,
        "enable_mls": args.enableMLS,
        "enable_nid_optimize": args.enableNIDOptimize,
        "enable_manual_guess": args.enableInitialGuessManual,
        "correspondences_path": args.correspondences,
        "resume": args.resume,
        "profile_trace_dir": args.profile_trace_dir,
    }
    for k, v in overrides.items():
        if v is not None:
            setattr(cfg, k, v)
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.dump_config:
        print(cfg.to_json())
        return 0
    if not cfg.point_cloud_path or not cfg.odometry_path or not cfg.images_folder:
        print(
            "error: --point_cloud_path, --odometry_path and --images_folder are required",
            file=sys.stderr,
        )
        return 2
    if not cfg.output_path:
        cfg.output_path = "."

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from .pipeline import runner
    from .utils import compile_cache

    compile_cache.enable()

    result = runner.process(cfg)
    summary = {
        "keyframes": result.num_keyframes,
        "colored_points": result.num_colored_points,
        "colored_cloud": result.colored_cloud_path,
        "mask_cloud": result.mask_cloud_path or None,
        "nid": result.nid_value,
        "timings_s": {k: round(v, 3) for k, v in result.timings.items()},
    }
    if result.T_correction is not None:
        import numpy as np

        summary["T_correction"] = {
            "quat_wxyz": np.asarray(result.T_correction.q).tolist(),
            "translation": np.asarray(result.T_correction.t).tolist(),
        }
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
