"""Every test file of the port pins torch to one CPU thread: each
``tests/test_torch_*.py`` and the multi-rank worker import
``tests/torch_threads.py`` at module level, so that the pin holds in every
xdist worker from collection on (the tier-1 command sets no thread
variable)."""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import ast
import pathlib

import torch

TESTS = pathlib.Path(__file__).resolve().parent


def _imports_pin(path: pathlib.Path) -> bool:
    return any(isinstance(node, ast.Import) and any(a.name == "torch_threads" for a in node.names)
               for node in ast.parse(path.read_text()).body)


def test_every_port_test_file_imports_the_pin():
    files = sorted(TESTS.glob("test_torch_*.py")) + [TESTS / "torch_mp_worker.py"]
    assert len(files) > 40
    missing = [p.name for p in files if not _imports_pin(p)]
    assert not missing, f"not importing torch_threads at module level: {missing}"


def test_the_pin_holds():
    assert torch.get_num_threads() == 1
