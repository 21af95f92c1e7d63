"""The port's launchers, `icl_tpu_torch/scripts/train.sh` and `test.sh`,
against the JAX package's `scripts/train.sh` and `test.sh`: every command
line they hold, run or commented out, is parsed by the port CLI's own
argument parser, and each command line of the JAX launchers appears in
the port's with the same arguments (the JAX train.sh's `--labeled_num 3
...` line, which elides its arguments, as the first line's data, experiment
and model with `--labeled_num 3`).
"""
import importlib
import re
import shlex
import subprocess
from pathlib import Path

import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "icl_tpu_torch" / "scripts"


def _command_lines(path: Path, start: str) -> list:
    """[(program, argv)] of the lines that begin with `start`, commented out
    or not, continuation lines joined, `${VAR:-default}` as its default."""
    out, current = [], None
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if line.startswith("#"):
            line = line[1:].strip()
        if current is None and not line.startswith(start + " "):
            continue
        current = (current or "") + " " + line.rstrip("\\")
        if not line.endswith("\\"):
            words = shlex.split(re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", current))
            out.append((words[1], words[2:]))
            current = None
    return out


@pytest.mark.parametrize("launcher", ["train.sh", "test.sh"])
def test_port_launcher_commands_parse_with_the_port_clis(launcher):
    path = PORT / launcher
    assert subprocess.run(["bash", "-n", str(path)]).returncode == 0
    commands = _command_lines(path, "run")
    assert len(commands) == {"train.sh": 6, "test.sh": 3}[launcher]
    for module, argv in commands:
        cli = importlib.import_module(f"icl_tpu_torch.scripts.{module}")
        args = cli.parse_args(argv)
        for flag, value in zip(argv, argv[1:]):
            if flag.startswith("--") and not value.startswith("--") and flag != "--patch_size":
                assert str(getattr(args, flag[2:])) == value, (module, flag)
        if "--patch_size" in argv:
            assert args.patch_size == [224, 224]


@pytest.mark.parametrize("launcher", ["train.sh", "test.sh"])
def test_port_launchers_hold_the_jax_launchers_command_lines(launcher):
    port = {(m, tuple(a)) for m, a in _command_lines(PORT / launcher, "run")}
    jax_lines = _command_lines(ROOT / "scripts" / launcher, "python")
    assert jax_lines
    for script, argv in jax_lines:
        if argv[-1] == "...":  # `--labeled_num 3 ...`: the first line's data and experiment
            base = next(a for s, a in jax_lines if s == script and a[-1] != "...")
            argv = base[:base.index("--labeled_num")] + argv[:-1]
        assert (script.removesuffix(".py"), tuple(argv)) in port, (script, argv)
