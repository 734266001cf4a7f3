# -*- coding: utf-8 -*-
"""The PyTorch port stands alone: no module of `fddm_asr_tpu_torch`, and not
`chip_smoke.py`, imports JAX, Flax or the JAX package, nor transformers,
safetensors or pandas, because the GPU machine has none of them, nor the
repository's own scripts (`serve.py`, `inference.py`, `train.py`,
`bench.py`).  YAML is imported lazily, only by the config loader.  Checked
statically over every import statement, and by importing the port in a
fresh interpreter."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fddm_asr_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fddm_asr_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imports(path):
    """(top-level module, line, inside a function) for every import in `path`."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            nested = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], child.lineno, in_function)
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                out.append((child.module.split(".")[0], child.lineno, in_function))
            visit(child, nested)

    visit(tree, False)
    return out


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_imports(path):
    bad = [(mod, line) for mod, line, _ in _imports(path) if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


ROOT_SCRIPTS = {"serve", "inference", "train", "bench"}


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_root_script_imports(path):
    """The port has its own server and CLI: a bare `import serve` would be
    the JAX package's."""
    bad = [(mod, line) for mod, line, _ in _imports(path) if mod in ROOT_SCRIPTS]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# what the GPU machine lacks besides JAX: the port reads HF checkpoints, safetensors
# files and CSVs with its own code
ABSENT_ON_THE_CARD = {"transformers", "safetensors", "pandas"}


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_transformers_safetensors_or_pandas_imports(path):
    bad = [(mod, line) for mod, line, _ in _imports(path) if mod in ABSENT_ON_THE_CARD]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_yaml_is_imported_by_load_yaml_alone():
    """The one `import yaml` of the port and chip_smoke.py is the one in
    `config.load_yaml`, so building a pipeline in code needs no YAML package."""
    found = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    if isinstance(node, ast.Import) and any(
                            a.name.split(".")[0] == "yaml" for a in node.names):
                        found.append((os.path.relpath(path, ROOT), fn.name))
    assert sorted(set(found)) == [("fddm_asr_tpu_torch/config.py", "load_yaml")]


def test_yaml_only_inside_functions():
    top_level = [(os.path.relpath(p, ROOT), line) for p in _port_files()
                 for mod, line, in_function in _imports(p) if mod == "yaml" and not in_function]
    assert not top_level, f"yaml imported at module level: {top_level}"


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke, fddm_asr_tpu_torch.pipeline, fddm_asr_tpu_torch.inference\n"
        "import fddm_asr_tpu_torch.serve, fddm_asr_tpu_torch.data.mp3\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'flax', 'yaml', "
        "'fddm_asr_tpu', 'serve', 'inference'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_walk_covers_the_serving_modules():
    walked = {os.path.relpath(p, PORT) for p in _port_files()}
    for module in ("serve.py", "data/mp3.py", "data/wire.py", "data/audio_io.py"):
        assert module in walked


def test_walk_covers_the_kernel_modules_and_their_sources():
    """The walk above reaches every kernel wrapper module; every CUDA source
    and header `ops/_build.py` names is in the package; and the build directory
    the libraries go to is listed in .gitignore."""
    from fddm_asr_tpu_torch.ops import _build

    walked = {os.path.relpath(p, PORT) for p in _port_files()}
    for module in ("ops/_build.py", "ops/flash_attention.py", "ops/quant.py",
                   "ops/conv_frontend.py"):
        assert module in walked
    for name in (*_build.SOURCES.values(), *_build.HEADERS):
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, name)), name
    on_disk = {n for n in os.listdir(_build.CSRC_DIR) if n.endswith((".cu", ".cuh"))}
    assert on_disk == {*_build.SOURCES.values(), *_build.HEADERS}
    with open(os.path.join(ROOT, ".gitignore"), encoding="utf-8") as f:
        ignored = {line.strip() for line in f}
    assert os.path.relpath(_build.BUILD_DIR, ROOT) + "/" in ignored


def test_cuda_sources_include_no_framework_header():
    """The kernels have a plain C interface (ctypes): no source includes a
    PyTorch or Python header, so nvcc builds each in seconds."""
    from fddm_asr_tpu_torch.ops import _build

    for name in (*_build.SOURCES.values(), *_build.HEADERS):
        with open(os.path.join(_build.CSRC_DIR, name), encoding="utf-8") as f:
            includes = [line for line in f if line.lstrip().startswith("#include")]
        assert not [i for i in includes if "torch" in i or "ATen" in i or "Python.h" in i], name
