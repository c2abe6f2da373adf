"""The restart supervisor of the port (``tpuddp_torch/resilience/
supervisor.py``, ``python -m tpuddp_torch.supervise``) against the JAX
package's (``tpuddp/resilience/supervisor.py``, ``tools/supervise.py``), on
the CPU:

- both supervisors driven by the same fake child's exit-code scripts (all
  of ``tests/test_elastic.py``'s supervisor cases and more: the mesh-aware
  shrink, the restart budget at 0, ``set_world`` and ``request_stop`` from
  inside an attempt, another world variable), each with its own
  ``random.Random`` of one seed: equal histories, equal child environments
  per attempt (``$TPUDDP_WORLD_SIZE``, ``$TPUDDP_AUTO_RESUME``, the first
  attempt's variables stripped from the restarts) and equal delays;
- ``classify_exit`` and ``_shrunk_mesh`` over a grid, the policy's and the
  constructor's ``ValueError`` texts;
- the CLI: its parse of options and command equal to ``tools/
  supervise.py``'s, its refusals (no ``--``, no command, ``--flight-dir``),
  and a run over a child that exits 113 once and then 0.

Tolerance: exact (the delays are the same float arithmetic on the same
random draws)."""

import importlib.util
import os
import random
import subprocess
import sys

import pytest

from tpuddp.resilience import supervisor as jax_sup

from tpuddp_torch import supervise as cli
from tpuddp_torch.resilience import supervisor as sup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tools_supervise():
    spec = importlib.util.spec_from_file_location("tools_supervise",
                                                  os.path.join(ROOT, "tools", "supervise.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _policy(lib, **kw):
    return lib.SupervisorPolicy(**{"backoff_base": 0.01, "backoff_cap": 0.02, **kw})


# name -> (exit codes, the supervisor's keyword arguments, the policy's,
# actions taken inside an attempt: {attempt: ("set_world", n) | ("stop",)})
SCRIPTS = {
    "clean exit": ([0], {}, {}, {}),
    "preempted twice": ([75, 75, 0], {"first_attempt_env": {"TPUDDP_FAULT": "preempt@epoch=1"}},
                        {}, {}),
    "shrink on repeated 76": ([76, 76, 0], {"world_size": 8}, {"shrink_after": 2}, {}),
    "min_world blocks the shrink": ([76, 76, 76, 0], {"world_size": 2},
                                    {"shrink_after": 2, "min_world": 2}, {}),
    "the budget surfaces the last code": ([77, 77, 77], {}, {"max_restarts": 2}, {}),
    "backoff grows, jittered": ([1, 1, 1, 0], {},
                                {"backoff_base": 1.0, "backoff_cap": 100.0, "jitter": 0.5}, {}),
    "signal deaths back off": ([-9, -15, 0], {"world_size": 8}, {"shrink_after": 1}, {}),
    "a signal death resets the streak": ([76, -9, 76, 0], {"world_size": 8}, {"shrink_after": 2},
                                         {}),
    "crash then resume, auto-resume first": (
        [113, 0], {"auto_resume_first": True, "world_size": 1,
                   "first_attempt_env": {"TPUDDP_FAULT": "crash@step=5", "X_FIRST": "1"}}, {}, {}),
    "shrink to the floor": ([76] * 6 + [0], {"world_size": 8}, {"shrink_after": 1}, {}),
    "the mesh shrinks data first": ([76] * 5 + [0], {"world_size": 8, "model_size": 2},
                                    {"shrink_after": 1}, {}),
    "a budget of 0": ([1], {}, {"max_restarts": 0}, {}),
    "the cap holds": ([1] * 8 + [0], {}, {"backoff_base": 1.0, "backoff_cap": 3.0}, {}),
    "another world variable": ([75, 0], {"world_size": 3,
                                         "world_env_var": "TPUDDP_SERVING_REPLICAS"}, {}, {}),
    "set_world mid-drain": ([75, 0], {"world_size": 4}, {}, {0: ("set_world", 2)}),
    "request_stop": ([75, 0], {"world_size": 4}, {}, {0: ("stop",)}),
}


def _drive(lib, codes, kwargs, policy, actions, seed=7):
    """Run ``lib``'s supervisor over a fake child; ``(rc, history, envs,
    delays)``."""
    codes, envs, delays = list(codes), [], []
    box = {}

    def runner(argv, env):
        assert argv == ["python", "train.py"]
        envs.append(dict(env))
        act = actions.get(len(envs) - 1)
        if act and act[0] == "set_world":
            box["s"].set_world(act[1])
        elif act:
            box["s"].request_stop()
        return codes.pop(0)

    box["s"] = lib.RestartSupervisor(["python", "train.py"], policy=_policy(lib, **policy),
                                     runner=runner, sleep=delays.append,
                                     rng=random.Random(seed), **kwargs)
    rc = box["s"].run()
    return rc, box["s"].history, envs, delays


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_the_supervisor_is_the_jax_packages(monkeypatch, name):
    monkeypatch.setenv("TPUDDP_SPAWNED", "1")  # stripped from every child's environment
    monkeypatch.delenv("TPUDDP_AUTO_RESUME", raising=False)
    codes, kwargs, policy, actions = SCRIPTS[name]
    ours = _drive(sup, codes, kwargs, policy, actions)
    theirs = _drive(jax_sup, codes, kwargs, policy, actions)
    assert ours == theirs
    rc, history, envs, delays = ours
    assert all("TPUDDP_SPAWNED" not in e for e in envs)
    assert all(e["TPUDDP_AUTO_RESUME"] == "1" for e in envs[1:])
    first = kwargs.get("first_attempt_env", {})
    assert all(k not in e for e in envs[1:] for k in first)
    assert all(envs[0][k] == v for k, v in first.items())
    if name == "the mesh shrinks data first":
        assert [h[2] for h in history] == [8, 4, 2, 1, 1, 1]
        assert [e["TPUDDP_MODEL_SIZE"] for e in envs] == ["2", "2", "2", "1", "1", "1"]
    if name == "crash then resume, auto-resume first":
        assert history == [(0, 113, 1), (1, 0, 1)] and envs[0]["TPUDDP_AUTO_RESUME"] == "1"


def test_classify_exit_and_the_shrunk_mesh_are_the_jax_packages():
    for rc in range(-70, 260):
        assert sup.classify_exit(rc) == jax_sup.classify_exit(rc), rc
    for world in range(1, 17):
        for model in (None, 1, 2, 3, 4):
            for factor in (2, 3, 4):
                for floor in (0, 1, 2, 4):
                    made = []
                    for lib in (sup, jax_sup):
                        policy = lib.SupervisorPolicy(shrink_factor=factor, min_world=floor)
                        try:
                            made.append(lib.RestartSupervisor(
                                ["x"], policy=policy, world_size=world, model_size=model
                            )._shrunk_mesh())
                        except ValueError as e:
                            made.append(str(e))
                    assert made[0] == made[1], (world, model, factor, floor)


@pytest.mark.parametrize("kw", [{"max_restarts": -1}, {"shrink_factor": 1}, {"jitter": 1.5},
                                {"jitter": -0.1}])
def test_the_policys_value_errors_are_the_jax_packages(kw):
    with pytest.raises(ValueError) as ours:
        sup.SupervisorPolicy(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_sup.SupervisorPolicy(**kw)
    assert str(ours.value) == str(theirs.value)


def test_the_delay_is_the_jax_packages():
    for k in range(0, 12):
        for jitter in (0.0, 0.25, 1.0):
            a, b = random.Random(k), random.Random(k)
            assert sup.SupervisorPolicy(jitter=jitter).delay(k, a) == \
                jax_sup.SupervisorPolicy(jitter=jitter).delay(k, b)


def test_flight_dir_belongs_to_observability_part_2(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8: observability, part 2"):
        sup.RestartSupervisor(["x"], flight_dir=str(tmp_path))


# ---------------------------------------------------------------- the CLI --

ARGVS = [
    ["--", "python", "-m", "tpuddp_torch.train_native", "--settings_file", "s.yaml"],
    ["--world", "8", "--min-world", "2", "--", "python", "train.py", "--", "x"],
    ["--world", "4", "--model", "2", "--max-restarts", "3", "--backoff-base", "0.5",
     "--backoff-cap", "9", "--jitter", "0.1", "--shrink-after", "3", "--shrink-factor", "4",
     "--auto-resume", "--first-env", "TPUDDP_FAULT=crash@step=5", "--first-env", "A=b=c",
     "--flight-dir", "d", "--", "cmd"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_the_cli_parses_as_tools_supervise(argv):
    tools = _tools_supervise()
    ours, command = cli.parse_args(list(argv))
    theirs, their_command = tools.parse_args(list(argv))
    assert vars(ours) == vars(theirs) and command == their_command


@pytest.mark.parametrize("argv", [[], ["--world", "2"], ["--world", "2", "--"]])
def test_the_cli_refuses_as_tools_supervise(argv, capsys):
    tools = _tools_supervise()
    texts = []
    for parse in (cli.parse_args, tools.parse_args):
        with pytest.raises(SystemExit) as e:
            parse(list(argv))
        assert e.value.code == 2
        texts.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert texts[0] == texts[1]
    with pytest.raises(NotImplementedError, match="observability, part 2"):
        cli.main(["--flight-dir", "d", "--", "true"])


def test_the_cli_resumes_a_crashed_child(tmp_path):
    """``python -m tpuddp_torch.supervise`` over a child that exits 113 once
    (the injected crash's code) and then 0: exit 0, the restart with
    ``$TPUDDP_AUTO_RESUME=1`` and without the first attempt's variable."""
    child = ("import os, sys\n"
             "log = open(sys.argv[1], 'a')\n"
             "log.write(f\"{os.environ.get('TPUDDP_AUTO_RESUME')} {os.environ.get('X_FIRST')} "
             "{os.environ.get('TPUDDP_WORLD_SIZE')}\\n\")\n"
             "log.close()\n"
             "sys.exit(113 if os.environ.get('X_FIRST') else 0)\n")
    log = tmp_path / "attempts"
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TPUDDP_AUTO_RESUME", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tpuddp_torch.supervise", "--world", "1", "--backoff-base", "0.01",
         "--first-env", "X_FIRST=1", "--", sys.executable, "-c", child, str(log)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert log.read_text().splitlines() == ["None 1 1", "1 None 1"]
    assert "supervisor: child exited 113 (crash); restart 1/8" in proc.stderr
