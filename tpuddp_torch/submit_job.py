"""Cluster launch of the port — the counterpart of the root ``submit_job.py``
and of the reference tutorial's ``submit_job.py``, retargeted at GPU hosts.

    python -m tpuddp_torch.submit_job --settings_file F [--dry_run]

The settings file's ``local`` block is read in the JAX launcher's order,
the platform block first, then ``condor``:

- ``local.gpu`` -> ``launch_gpu.sh`` in ``out_dir`` (the counterpart of
  ``create_tpu_launch_script``): run on a host, it starts the port's entry
  point there, logging to ``info_${HOSTNAME}.log`` under ``out_dir``. Under
  ``local.rendezvous`` every host runs the same script with its own
  ``$TPUDDP_PROCESS_ID`` (``tpuddp_torch/configs/multihost_h100.yaml``'s
  header). The JAX script's ``gcloud ... ssh --worker=all`` starts every
  host of a TPU pod slice from one command; GPU hosts have no such fan-out
  without a list of hosts, which the settings schema does not hold, so the
  script is started on each host by whatever starts jobs there. Without
  ``--dry_run`` the launcher runs the script on this host.
- ``local.condor`` (the reference schema) -> ``submission_file.sub`` to the
  reference contract (executable, cpus, memory, gpus, the CUDA memory
  requirement, arguments, err/out/log under ``out_dir``, ``queue``), and
  without ``--dry_run`` ``condor_submit_bid <bid> <sub>``.
- neither: the JAX launcher's ``ValueError``.

``script_path`` names the entry point. One inside the package
(``tpuddp_torch/train_native.py``) becomes ``-m tpuddp_torch.train_native``:
the package's modules import it by name, so run as a file from the
repository's root they would not find it. Any other path is passed on as
written. Both the script and the ``.sub`` run from the directory the
launcher ran in, with the interpreter that ran it: run the launcher from
the repository's root.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

import yaml

PACKAGE = "tpuddp_torch"


def entry_arguments(script_path: str, settings_file: str) -> str:
    """The command line after the interpreter: ``-m tpuddp_torch.<module>``
    for a ``script_path`` inside the package, else the path as written,
    then ``--settings_file``."""
    parts = os.path.normpath(script_path).split(os.sep)
    if parts[0] == PACKAGE and parts[-1].endswith(".py"):
        module = ".".join(parts[:-1] + [parts[-1][:-3]])
        return f"-m {module} --settings_file {settings_file}"
    return f"{script_path} --settings_file {settings_file}"


def create_submission_file(out_dir: str, condor_settings: dict,
                           filename: str = "submission_file.sub") -> str:
    """HTCondor ``.sub`` to the reference contract (``submit_job.py:30-56``
    of the JAX package, the reference's ``:7-43``)."""
    lines = [f"executable = {condor_settings['executable']}"]
    lines.append(f"request_cpus = {condor_settings['num_cpus']}")
    lines.append(f"request_memory = {condor_settings['memory_cpus']}")
    if "num_gpus" in condor_settings:
        lines.append(f"request_gpus = {condor_settings['num_gpus']}")
    if "memory_gpus" in condor_settings:
        lines.append(f"requirements = TARGET.CUDAGlobalMemoryMb > {condor_settings['memory_gpus']}")
        lines.append("")
    lines.append(f'arguments = "{condor_settings["arguments"]}"')
    lines.append(f"error = {os.path.join(out_dir, 'info.err')}")
    lines.append(f"output = {os.path.join(out_dir, 'info.out')}")
    lines.append(f"log = {os.path.join(out_dir, 'info.log')}")
    lines.append("queue")
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def create_gpu_launch_script(out_dir: str, arguments: str, filename: str = "launch_gpu.sh") -> str:
    """The per-host launch script: ``cd`` to the launcher's working
    directory, run the entry point with the launcher's interpreter, tee its
    output to ``info_${HOSTNAME}.log`` in ``out_dir``; executable."""
    log = os.path.join(out_dir, "info_${HOSTNAME}.log")
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        f.write("#!/bin/bash\n")
        f.write("# Auto-generated by tpuddp_torch submit_job.py. Under local.rendezvous run it\n")
        f.write("# on every host with that host's TPUDDP_PROCESS_ID.\n")
        f.write("set -euo pipefail\n")
        f.write(f"cd {shlex.quote(os.getcwd())}\n")
        f.write(f'{shlex.quote(sys.executable)} {arguments} 2>&1 | tee "{log}"\n')
    os.chmod(path, 0o755)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Launch a tpuddp_torch training run on GPU hosts (local.gpu) or an "
        "HTCondor cluster (local.condor).",
    )
    parser.add_argument(
        "--settings_file", type=str, required=True,
        help="YAML settings naming script_path, out_dir, and a local.gpu or local.condor block.",
    )
    parser.add_argument("--dry_run", action="store_true",
                        help="Generate submission artifacts without submitting.")
    args = parser.parse_args(argv)

    with open(args.settings_file, "r") as f:
        settings = yaml.safe_load(f)
    out_dir = settings["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    arguments = entry_arguments(settings["script_path"], args.settings_file)
    local = settings.get("local") or {}

    if "gpu" in local:
        script = create_gpu_launch_script(out_dir, arguments)
        print(f"GPU launch script written to {script}")
        if not args.dry_run:
            return subprocess.call(["bash", script])
        return 0

    if "condor" in local:
        condor_settings = dict(local["condor"])
        condor_settings["arguments"] = arguments
        condor_settings["executable"] = sys.executable
        sub = create_submission_file(out_dir, condor_settings)
        print(f"Condor submission file written to {sub}")
        if not args.dry_run:
            return subprocess.call(["condor_submit_bid", str(condor_settings["bid"]), sub])
        return 0

    raise ValueError("settings.local must contain a 'gpu' or 'condor' block to submit")


if __name__ == "__main__":
    raise SystemExit(main())
