"""The check for JAX compares whole top-level names."""
import subprocess
import sys

from conftest import ROOT
from harness import guard


def test_whole_top_level_names():
    names = ["hpfx_torch", "hpfx_torch.lanes", "jaxtyping", "flaxen",
             "hpfx", "hpfx.solve", "jax.numpy", "jaxlib", "flax.linen",
             "torch"]
    assert guard.banned_modules(names) == ["flax.linen", "hpfx",
                                           "hpfx.solve", "jax.numpy",
                                           "jaxlib"]


def test_the_port_loads_none_of_them():
    code = ("import sys; sys.path[:0] = [%r, %r + '/portbench'];"
            "import hpfx_torch, hpfx_torch.parallel;"
            "from harness import cli, check, guard;"
            "print(guard.banned_modules())" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_a_loaded_module_ends_the_run(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "hpfx", object())
    try:
        guard.check("here")
    except SystemExit as e:
        assert e.code == 3
    else:
        raise AssertionError("no exit")
    assert "hpfx" in capsys.readouterr().err
