"""The PyTorch port stands alone: no file of ``epa_ng_tpu_torch/``, nor
``chip_smoke.py``, ``kernel_ab.py`` or ``kernel_sass.py``, imports JAX or
anything of the JAX package (the port keeps its own copies of the host
code it needs)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, n)
             for n in ("chip_smoke.py", "kernel_ab.py", "kernel_sass.py")]
    for d, subdirs, names in os.walk(os.path.join(ROOT, "epa_ng_tpu_torch")):
        # build/ holds what the package generates at run time
        subdirs[:] = [s for s in subdirs if s != "build"]
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "epa_ng_tpu")


def test_port_files_found():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert os.path.join(ROOT, "kernel_ab.py") in files
    assert os.path.join(ROOT, "kernel_sass.py") in files
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_native_build_renames_into_place(tmp_path):
    """The fastseq scanner builds under a name of its own process and
    renames the library into place, so concurrent processes never load a
    half-written one; a failed build leaves nothing behind."""
    from epa_ng_tpu_torch.io import native
    src = os.path.join(ROOT, "epa_ng_tpu_torch", "native", "fastseq.cpp")
    assert native._build(src, str(tmp_path / "lib.so"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("not c++\n")
    assert not native._build(str(bad), str(tmp_path / "bad.so"))
    assert sorted(os.listdir(tmp_path)) == ["bad.cpp", "lib.so"]
