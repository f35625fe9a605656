"""The tiny host sizes of patterns added to the benchmark after
``tests/conftest.py``, whose ``tiny_root`` cuts every configuration of
``BENCHMARK.json`` by its pattern's entry in ``TINY``: merged into that
``TINY`` when pytest loads it (run: ``python -m pytest -q portbench/tests``
from the root of the repository)."""
import pathlib

#: tiny sizes of the patterns ``tests/conftest.py``'s TINY lacks
TINY_ADDED = {"density": {"particles_per_axis": 8, "leaf_n": 128, "bs": 16}}

TESTS_CONFTEST = pathlib.Path(__file__).resolve().parent / "tests" / \
    "conftest.py"


def pytest_plugin_registered(plugin):
    path = getattr(plugin, "__file__", None)
    if path and pathlib.Path(path).resolve() == TESTS_CONFTEST:
        for pattern, size in TINY_ADDED.items():
            plugin.TINY.setdefault(pattern, size)
