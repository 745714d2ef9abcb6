"""Shipped-artifact hardening.

Every committed JSON record at the repo root must be valid STRICT JSON —
no bare NaN/Infinity tokens, which would both hide a defect and make the
file unparseable to strict readers.
"""

import json
import math
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

ARTIFACTS = sorted(ROOT.glob("*.json"))


def _strict_load(path):
    def reject(tok):
        raise ValueError(f"non-strict JSON token {tok!r} in {path.name}")

    return json.loads(path.read_text(), parse_constant=reject)


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name)
def test_artifact_is_strict_json(path):
    _strict_load(path)


def _walk_floats(obj, path=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk_floats(v, f"{path}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _walk_floats(v, f"{path}[{i}]")
    elif isinstance(obj, float):
        yield path, obj


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name)
def test_artifact_floats_finite(path):
    # Strict parsing already rejects NaN/Infinity tokens; this guards a
    # future serializer writing them as strings or huge literals.
    data = _strict_load(path)
    bad = [(p, v) for p, v in _walk_floats(data) if not math.isfinite(v)]
    assert not bad, bad
