"""Every lesson of the port (tutorials_torch/) runs on the CPU, as
tests/test_tutorials.py runs the JAX package's lessons. The lessons are
loaded by path under names of their own: the JAX lessons' test imports
its lessons by bare name after a sys.path insert, and both tests can run
in one worker."""
import importlib.util
import pathlib

import pytest

DIR = pathlib.Path(__file__).parent.parent / "tutorials_torch"
LESSONS = sorted(p.stem for p in DIR.glob("lesson_*.py"))


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"halide_tpu_torch_tutorial_{name}", DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_jax_lesson_has_a_port_twin():
    jax_dir = DIR.parent / "tutorials"
    numbers = {p.stem[:9] for p in jax_dir.glob("lesson_*.py")}
    assert {n[:9] for n in LESSONS} == numbers and len(LESSONS) == 30


@pytest.mark.parametrize("name", LESSONS)
def test_tutorial(name):
    load(name).main("cpu")
