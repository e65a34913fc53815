"""Scene fixture resolution: the repo is self-contained.

`scenes/` at the repo root carries the scene descriptions, the teapot / cow /
alien meshes and the golden render, so every test and demo of the port runs
from the checkout alone.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_SCENES = os.path.join(REPO_ROOT, "scenes")


def scene_path(name: str) -> str:
    """Resolve a scene JSON (e.g. "cornell" or "cornell.json") to a path."""
    if not name.endswith(".json"):
        name += ".json"
    p = os.path.join(REPO_SCENES, name)
    if not os.path.exists(p):
        raise FileNotFoundError(f"scene '{name}' not found in {REPO_SCENES}")
    return p


def model_path(name: str) -> str:
    """Resolve a mesh file (e.g. "teapot.obj") the same way."""
    p = os.path.join(REPO_SCENES, "models", name)
    if not os.path.exists(p):
        raise FileNotFoundError(f"model '{name}' not found")
    return p


def golden_path() -> str:
    """The reference Cornell 5000-spp golden render (PNG), checked in."""
    p = os.path.join(REPO_SCENES, "golden", "REFERENCE_cornell.5000samp.png")
    if not os.path.exists(p):
        raise FileNotFoundError("golden render not found")
    return p
