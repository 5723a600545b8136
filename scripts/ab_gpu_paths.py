#!/usr/bin/env python
"""A/B of ScoreConfig.gather_mode in the full-width track frame, one GPU.

    python scripts/ab_gpu_paths.py [--rounds 4] [--calls 10]

The track frame program at the benchmark configuration (asym object,
VGA, 512 particles) is compiled once per gather mode ("take": XLA
gathers; "mxu": separable one-hot matmuls), then timed in interleaved
rounds so drift hits both alike. Prints one line per variant, beside the
card's name and power limit, and a JSON summary last. GPU only.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_ms(fn, calls):
    ts = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def main() -> None:
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from icra20_hand_object_pose_tpu.benchmarks import require_gpu
    from icra20_hand_object_pose_tpu.datasets import (
        SyntheticSequenceConfig, generate_sequence,
    )
    from icra20_hand_object_pose_tpu.models import Estimator, ObjectModel

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=10)
    a = ap.parse_args()
    dev = require_gpu()
    card = chip_smoke.card_line()
    say = functools.partial(chip_smoke.say, card)

    mesh, hand, cfg = chip_smoke.benchmark_setup("asym")
    fr = generate_sequence(mesh, hand, SyntheticSequenceConfig(
        n_frames=2, camera=cfg.camera, noise_sigma=0.001, seed=0))[1]
    args = (jnp.asarray(fr.depth), jnp.asarray(fr.pose_gt),
            jnp.asarray(fr.hand_base), jnp.asarray(fr.hand_q))
    obj = ObjectModel(mesh, model_points=1024, render_points=2048)
    variants = {
        gm: Estimator(obj, hand, dataclasses.replace(
            cfg, score=dataclasses.replace(cfg.score, gather_mode=gm)))
        for gm in ("take", "mxu")
    }
    for label, est in variants.items():
        t = time.perf_counter()
        est.estimate(*args, key=jax.random.key(0)).pose.block_until_ready()
        say(f"frame gather_mode={label}: compile + first call "
            f"{time.perf_counter() - t:.1f} s")
    times = {k: [] for k in variants}
    for rnd in range(a.rounds):
        order = list(variants) if rnd % 2 == 0 else list(variants)[::-1]
        for label in order:
            est = variants[label]
            times[label].append(_median_ms(
                lambda: est.estimate(*args, key=jax.random.key(1))
                .pose.block_until_ready(), a.calls))
    for label, ts in times.items():
        say(f"frame gather_mode={label} (track program): per-round medians "
            f"{[round(t, 3) for t in ts]} ms")
    print(json.dumps({"device": dev, "card": card, "frame_ms": times}))


if __name__ == "__main__":
    main()
