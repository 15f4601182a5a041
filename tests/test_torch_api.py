"""The port's public surface (``repro_torch.api``) against the
reference's (``repro.api``): the same names, each bound to the port's own
object, and importing it pulls in neither jax nor the reference."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

import repro.api as japi
import repro_torch.api as api
import repro_torch.testing  # noqa: F401  (one torch thread per xdist worker)


def test_api_names_match_reference():
    assert api.__all__ == japi.__all__
    assert len(api.__all__) == 18


@pytest.mark.parametrize("name", japi.__all__)
def test_api_name_is_the_ports(name):
    obj = getattr(api, name)
    mod = getattr(obj, "__module__", None) or type(obj).__module__
    assert mod.startswith("repro_torch."), (name, mod)
    assert obj is not getattr(japi, name)


def test_api_and_sweep_import_without_jax_or_reference():
    code = ("import sys, repro_torch.api, repro_torch.sweep; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
