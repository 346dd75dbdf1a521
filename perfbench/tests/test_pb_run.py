"""``run.py`` as the driver calls it: no result without a card, and none in
a directory that holds only the benchmark's own files."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import cells

ARGS = ["--workload", "infer-stack600", "--seed", str(2 ** 31 + 11),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=str(cwd), capture_output=True, text=True,
                          timeout=300, env=env)


def _is_result(line: str) -> bool:
    try:
        return "correct" in json.loads(line)
    except ValueError:
        return False


def test_only_the_benchmarks_files_give_no_result(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert not any(_is_result(x) for x in out.stdout.splitlines())


def test_no_card_gives_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(cells.ROOT)
    assert out.returncode == 2, out.stderr
    assert out.stdout == ""
