"""The port's cluster launcher (``tpuddp_torch/submit_job.py``) against the
JAX package's (the root ``submit_job.py``), on the CPU with ``--dry_run``:
the claims of ``tests/test_entrypoints.py``'s three launcher tests for
``local.gpu``, ``local.condor`` and neither, and the command each writes
run from the repository's root (``--help``: exit 0), which a bare
``python tpuddp_torch/train_native.py`` does not."""

import os
import shlex
import subprocess
import sys

import pytest
import yaml

import submit_job as jax_submit
from tpuddp_torch import submit_job

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SETTINGS = os.path.join(ROOT, "tpuddp_torch", "configs", "cifar10_alexnet_h100.yaml")
CONDOR = {"bid": 50, "num_cpus": 2, "memory_cpus": 128000, "num_gpus": 2, "memory_gpus": 60000}


def _settings(tmp_path, local, script_path="tpuddp_torch/train_native.py"):
    settings = {"script_path": script_path, "out_dir": str(tmp_path / "out"), "local": local}
    sf = tmp_path / "s.yaml"
    sf.write_text(yaml.dump(settings))
    return sf


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)  # the command must find the package from the root alone
    return env


def test_gpu_dry_run_writes_an_executable_launch_script(tmp_path):
    sf = _settings(tmp_path, {"device": "cuda", "gpu": {"num_gpus": 8}})
    assert submit_job.main(["--settings_file", str(sf), "--dry_run"]) == 0
    script = tmp_path / "out" / "launch_gpu.sh"
    text = script.read_text()
    assert text.startswith("#!/bin/bash\n")
    assert "set -euo pipefail" in text
    assert f"-m tpuddp_torch.train_native --settings_file {sf}" in text
    assert f'tee "{tmp_path / "out"}/info_${{HOSTNAME}}.log"' in text
    assert "TPUDDP_PROCESS_ID" in text  # each host's id under local.rendezvous
    assert os.access(script, os.X_OK)


def test_condor_dry_run_is_the_reference_submission_file(tmp_path):
    """The port's .sub is the JAX launcher's line for line but for the
    arguments, which name the port's entry point as a module."""
    sf = _settings(tmp_path, {"device": "cuda", "condor": dict(CONDOR)})
    assert submit_job.main(["--settings_file", str(sf), "--dry_run"]) == 0
    sub = (tmp_path / "out" / "submission_file.sub").read_text()
    assert f"executable = {sys.executable}" in sub
    assert "request_gpus = 2" in sub
    assert "TARGET.CUDAGlobalMemoryMb > 60000" in sub
    assert sub.rstrip().endswith("queue")
    assert f'arguments = "-m tpuddp_torch.train_native --settings_file {sf}"' in sub
    jax_dir = tmp_path / "jax"
    jax_sf = tmp_path / "jax.yaml"
    jax_sf.write_text(yaml.dump({"script_path": "train_native.py", "out_dir": str(jax_dir),
                                 "local": {"condor": dict(CONDOR)}}))
    assert jax_submit.main(["--settings_file", str(jax_sf), "--dry_run"]) == 0
    jax_sub = (jax_dir / "submission_file.sub").read_text()
    strip = [line for line in sub.splitlines() if not line.startswith(("arguments", "error", "output", "log"))]
    assert strip == [line for line in jax_sub.splitlines()
                     if not line.startswith(("arguments", "error", "output", "log"))]
    for name in ("error", "output", "log"):
        assert f"{name} = {tmp_path / 'out'}/info." in sub


def test_neither_block_is_the_jax_value_error(tmp_path):
    sf = _settings(tmp_path, {"device": "cuda"})
    with pytest.raises(ValueError, match="'gpu' or 'condor'"):
        submit_job.main(["--settings_file", str(sf), "--dry_run"])
    jax_sf = tmp_path / "jax.yaml"
    jax_sf.write_text(yaml.dump({"script_path": "x", "out_dir": str(tmp_path), "local": {}}))
    with pytest.raises(ValueError, match="'tpu' or 'condor'"):
        jax_submit.main(["--settings_file", str(jax_sf), "--dry_run"])


def test_platform_block_comes_before_condor(tmp_path):
    sf = _settings(tmp_path, {"gpu": {"num_gpus": 1}, "condor": dict(CONDOR)})
    assert submit_job.main(["--settings_file", str(sf), "--dry_run"]) == 0
    assert (tmp_path / "out" / "launch_gpu.sh").exists()
    assert not (tmp_path / "out" / "submission_file.sub").exists()


@pytest.mark.parametrize("script_path,expected", [
    ("tpuddp_torch/train_native.py", "-m tpuddp_torch.train_native"),
    ("tpuddp_torch/train_accelerate.py", "-m tpuddp_torch.train_accelerate"),
    ("./tpuddp_torch/submit_job.py", "-m tpuddp_torch.submit_job"),
    ("train_native.py", "train_native.py"),
    ("/opt/run/train.py", "/opt/run/train.py"),
])
def test_entry_arguments(script_path, expected):
    assert submit_job.entry_arguments(script_path, "f.yaml") == f"{expected} --settings_file f.yaml"


def test_every_port_settings_file_names_a_package_entry_point():
    configs = os.path.join(ROOT, "tpuddp_torch", "configs")
    for name in sorted(os.listdir(configs)):
        with open(os.path.join(configs, name)) as f:
            script = yaml.safe_load(f)["script_path"]
        assert submit_job.entry_arguments(script, name).startswith("-m tpuddp_torch.train_"), name


def test_the_written_command_runs_from_the_repository_root(tmp_path):
    """The repair: the arguments the launcher writes for a port settings
    file run (``--help``) from the root, both in the ``.sub`` and in the
    launch script; the file path a settings file names does not."""
    with open(PORT_SETTINGS) as f:
        settings = yaml.safe_load(f)
    for block in ("condor", "gpu"):
        out = tmp_path / block
        sf = tmp_path / f"{block}.yaml"
        sf.write_text(yaml.dump({**settings, "out_dir": str(out),
                                 "local": {"device": "cuda", block: dict(CONDOR) if block == "condor"
                                           else {"num_gpus": 1}}}))
        assert submit_job.main(["--settings_file", str(sf), "--dry_run"]) == 0
        if block == "condor":
            line = next(ln for ln in (out / "submission_file.sub").read_text().splitlines()
                        if ln.startswith("arguments = "))
            args = shlex.split(line[len("arguments = "):].strip('"'))
        else:
            line = (out / "launch_gpu.sh").read_text().strip().splitlines()[-1]
            args = shlex.split(line.split(" 2>&1")[0])[1:]
        done = subprocess.run([sys.executable, *args, "--help"], cwd=ROOT, env=_env(),
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr
        assert "--settings_file" in done.stdout
    bare = subprocess.run([sys.executable, settings["script_path"], "--help"], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert bare.returncode != 0 and "No module named 'tpuddp_torch'" in bare.stderr
