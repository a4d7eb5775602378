"""Shared CLI plumbing for the pipeline scripts (trajectory / simulator /
excite / identifier), mirroring the reference's argparse + YAML pattern
(reference: identifier.py:1441-1505, simulator.py:20-80)."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from .config import load_config

# fixed in-checkout default: the cache key includes the directory, so a
# cache that moves between runs never hits
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_jax(prefer_cpu: bool = False) -> str:
    """Apply the platform choice of JAX_PLATFORMS, enable the persistent
    compilation cache and return its directory. prefer_cpu pins the
    process to the host backend — for CLIs with no accelerator content
    (visualization), which should neither wait on device dispatches nor
    reserve the card's memory.

    The compilation cache matters a lot here: big unrolled-tree graphs
    (30-DOF regressor batches, suspended-base scans) take minutes to
    compile cold but re-load in seconds across processes."""
    import jax

    plat = "cpu" if prefer_cpu else os.environ.get("JAX_PLATFORMS")
    if plat:
        # keep the host backend registered: the parameter-space solvers
        # (conic.py) pin themselves to jax.devices("cpu"), and an
        # exclusive accelerator platform list would hide it
        # (RuntimeError: Unknown backend cpu)
        plats = [p.strip() for p in plat.split(",") if p.strip()]
        if "cpu" not in plats:
            plats.append("cpu")
        try:
            jax.config.update("jax_platforms", ",".join(plats))
        except RuntimeError:
            pass  # backends already initialized
    return enable_compilation_cache()


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory: JAX_COMPILATION_CACHE_DIR when set (JAX reads that
    variable itself, so no other directory is set here), else
    `<repo>/.jax_cache`."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(REPO_CACHE_DIR)
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True, help="YAML configuration file")
    p.add_argument("-m", "--model", required=True, help="robot URDF model file")
    p.add_argument("--regressor", help="regressor XML with joint name ordering")
    return p


def load_cli_config(args) -> dict:
    cfg = load_config(args.config)
    cfg["urdf"] = args.model
    if getattr(args, "regressor", None):
        cfg["regressor"] = args.regressor
    return cfg
