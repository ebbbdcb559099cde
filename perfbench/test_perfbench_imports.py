"""Nothing the benchmark runs imports JAX, its libraries or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), the reference imports nothing of the program, and no
source reads the JAX package's benchmark folder."""

import ast
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        found = set(_imports(f)) & FORBIDDEN
        assert not found, f"{f.relative_to(HERE)} imports {found}"


def test_reference_is_independent_of_the_program():
    """Every file under ``reference/`` and every file a configuration
    names as its reference."""
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    named = {(HERE.parent / json.loads((HERE.parent / c["file"]).read_text())["reference"])
             .resolve() for c in spec["configs"]}
    assert named
    for f in sorted(set((HERE / "reference").rglob("*.py")) | named):
        names = set(_imports(f))
        assert names <= {"__future__", "math", "typing", "torch"}, (f, names)


def test_nothing_reads_the_jax_benchmarks():
    for f in sorted(HERE.rglob("*")):
        if f.is_file() and f.suffix in (".py", ".json") and f != pathlib.Path(__file__):
            text = f.read_text()
            assert "benchmarks/" not in text and '"benchmarks"' not in text, f
