"""No module of the benchmark imports JAX or the JAX package (whole
top-level names: ``repro_torch`` begins with ``repro``) or reads the JAX
package's benchmarks, and the reference imports nothing of the program."""
import ast
from pathlib import Path

from hadbench import run

HERE = Path(run.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out |= {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            out.add(node.args[0].value)
    return out


def _modules():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        assert "benchmarks/" not in path.read_text(), path


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in _modules() if "reference" in p.parts]
    assert ref
    allowed = {"hadbench.weights", "hadbench.flops"}
    for path in ref:
        for m in _imports(path):
            assert m.split(".")[0] != "repro_torch", (path, m)
            if m.startswith("hadbench"):
                assert m in allowed or m.startswith("hadbench.reference"), m
    # what the reference draws its weights with, and the FLOP formula its
    # model module hands on, import no program either
    for name in ("weights.py", "flops.py"):
        assert not {m.split(".")[0] for m in _imports(HERE / name)} \
            & {"repro_torch", "repro", "hadbench"}, name


def test_run_names_jax_by_whole_top_level_names():
    names = ["torch", "repro_torch.serve.engine", "jax.numpy", "jaxlib",
             "repro.models", "flaxen", "reprox"]
    assert run.forbidden_modules(names) == ["jax", "jaxlib", "repro"]
