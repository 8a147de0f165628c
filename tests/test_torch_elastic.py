"""Elastic resize in the port: format-2 checkpoints restored onto another
world size and layout, the ``resize`` marker, and the port's launcher's
supervisor (shrink, floor, regrow), against the JAX package's contract
(``tests/test_elastic.py``).

Gloo groups of CPU processes through the port's launcher
(``tests/torch_dist_cases.py``): ``bert_small`` (vocabulary 512, seeded
weights) trains 2
Adam steps on tp2 over 2 processes and saves in format 2; 4 processes
restore it onto dp4 and dp2 x tp2 (2 -> 4) and save it again; 2 processes
restore that onto tp2 and dp2 (4 -> 2).  Every restored state, gathered,
equals the saved one bit for bit.  The supervisor's tests run torch-free
workers through ``mxnet_tpu_torch/tools/launch.py`` as a script.  One
end-to-end shrink: a 3-process gang under ``--elastic`` loses rank 2 at
step 3 of every world-3 incarnation (``crash:step=3:rank=2:if-world=3``),
shrinks to 2, resumes from the step-2 checkpoint written at world 3, and
ends with the weights of a fixed 2-process gang resumed from a copy of
the same checkpoint, bit for bit.
"""
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

LAUNCH = os.path.join(ROOT, "mxnet_tpu_torch", "tools", "launch.py")
CASES = os.path.join(ROOT, "tests", "torch_dist_cases.py")


def _elastic_gang(out):
    """The 3-process ``--elastic`` gang of the end-to-end shrink."""
    env = dict(os.environ, MX_FAULT_SPEC="crash:step=3:rank=2:if-world=3")
    return subprocess.run(
        [sys.executable, LAUNCH, "-n", "3", "--force-cpu", "--elastic",
         "--max-restarts", "0", "--term-timeout", "1",
         "--restart-backoff", "0.1", "--", sys.executable, CASES, str(out),
         "elastic"], capture_output=True, text=True, timeout=240, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The resize groups (2, then 4, then 2 processes) beside the elastic
    gang; the baseline runs with the last resize group."""
    out = tmp_path_factory.mktemp("elastic")
    gang = {}
    t = threading.Thread(target=lambda: gang.update(res=_elastic_gang(out)))
    t.start()
    assert cases.start_group(out, 2, "resize_save2")() == 0
    assert cases.start_group(out, 4, "resize_2to4")() == 0
    t.join(240)
    res = gang["res"]
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    base = out / "baseline"
    base.mkdir()
    shutil.copytree(out / "ckpt", base / "ckpt")
    (base / "resume_step").write_text("2")
    assert cases.start_group(out, 2, "resize_4to2", "elastic_baseline")() \
        == 0
    files = {n: dict(np.load(out / f"{n}-0.npz"))
             for n in ("resize_save2", "resize_2to4", "resize_4to2")}
    return {"dir": out, "gang": res, "files": files}


def _section(got, tag):
    key = f"{tag}:"
    return {k[len(key):]: v for k, v in got.items() if k.startswith(key)}


@pytest.mark.parametrize("src,tag,old,new", [
    ("resize_2to4", "dp4", 2, 4), ("resize_2to4", "dp2tp2", 2, 4),
    ("resize_4to2", "tp2", 4, 2), ("resize_4to2", "dp2", 4, 2)])
def test_restore_onto_another_world_equals_the_gathered_oracle(
        runs, src, tag, old, new):
    oracle = _section(runs["files"]["resize_save2"], "oracle")
    got = runs["files"][src]
    mine = {k: v for k, v in _section(got, tag).items()
            if k not in ("info", "step")}
    assert set(mine) == set(oracle)
    for k, v in oracle.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    info = json.loads(str(got[f"{tag}:info"]))
    assert info["resharded"] and (info["old_world"], info["new_world"]) \
        == (old, new)
    assert int(got[f"{tag}:step"]) == cases.STEPS


def test_two_to_four_wrote_four_ranks_of_shards(runs):
    """The dp2 x tp2 save: ranks 0 and 1 own the blocks and write the
    shard files and markers, 2 and 3 nothing."""
    d = runs["dir"] / "r4" / f"step-{cases.STEPS}"
    meta = json.load(open(d / "meta.json"))
    assert meta["world_size"] == 4
    owners = {s["rank"] for e in meta["manifest"]["params"].values()
              for s in e["shards"]}
    assert owners == {0, 1}
    files = sorted(p for p in os.listdir(d) if p.endswith(".nd"))
    assert files == ["optstate-shard-0.nd", "optstate-shard-1.nd",
                     "params-shard-0.nd", "params-shard-1.nd"]
    # an owner of nothing commits no marker and leaves no staging dir
    assert sorted(p for p in os.listdir(d) if p.startswith("shard-")) == [
        "shard-0.json", "shard-1.json"]
    assert not [p for p in os.listdir(d.parent) if p.startswith(".tmp-")]


def test_elastic_shrink_end_to_end(runs):
    res = runs["gang"]
    assert res.stdout.count("injected crash at step 3") == 1, res.stdout
    assert "shrinking gang 3 -> 2" in res.stderr, res.stderr
    assert res.stdout.count(
        "resuming at step 2 world 2 resharded=True old_world=3") == 2, \
        res.stdout
    assert res.stdout.count("done") == 2, res.stdout
    elastic = np.load(runs["dir"] / "final_elastic.npz")
    base = np.load(runs["dir"] / "final_baseline.npz")
    assert set(elastic.files) == set(base.files)
    for k in elastic.files:
        np.testing.assert_array_equal(elastic[k], base[k], err_msg=k)


def _resize_events(tmp_path, monkeypatch, run, env):
    """The ``resize`` and ``reshard`` events of one restore of a state
    saved at world 3 into a one-process step, under ``env``."""
    import glob

    from mxnet_tpu_torch import context, gluon, telemetry
    from mxnet_tpu_torch.parallel import DataParallelStep

    for k in ("MX_ELASTIC", "MX_PREV_NUM_PROCS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("MX_TELEMETRY_DIR", "")
    telemetry.reset()
    d = str(tmp_path / run)
    telemetry.enable(d)
    try:
        net = gluon.nn.Dense(3, in_units=6, prefix="rz_")
        net.initialize(ctx=context.cpu())
        step = DataParallelStep(net, gluon.loss.L2Loss(), optimizer="adam",
                                device="cpu")
        state = step.state_dict()
        saved = dict(step.layout(), world_size=3)
        info = step.load_state_dict(state, saved_layout=saved)
        assert info["resharded"] and info["old_world"] == 3
        telemetry.flush()
    finally:
        telemetry.reset()
    events = [json.loads(line)
              for f in glob.glob(os.path.join(d, "rank-*.jsonl"))
              for line in open(f)]
    return ([e for e in events if e.get("kind") == "resize"],
            [e for e in events if e.get("kind") == "reshard"])


@pytest.mark.parametrize("env,marked", [
    ({}, True), ({"MX_ELASTIC": "1"}, False),
    ({"MX_PREV_NUM_PROCS": "3"}, False)])
def test_resize_marker_only_for_a_manual_resize(tmp_path, monkeypatch, env,
                                                marked):
    resizes, reshards = _resize_events(tmp_path, monkeypatch, "run", env)
    assert reshards
    if marked:
        assert len(resizes) == 1
        assert (resizes[0]["old_world"], resizes[0]["new_world"],
                resizes[0]["source"]) == (3, 1, "restore")
    else:
        assert resizes == []


# ---------------------------------------------------------------------------
# the supervisor, with torch-free workers
# ---------------------------------------------------------------------------
def _supervise(tmp_path, body, n, extra=(), timeout=90):
    worker = tmp_path / "worker.py"
    worker.write_text(body)
    return subprocess.run(
        [sys.executable, LAUNCH, "-n", str(n), "--restart-backoff", "0.05",
         "--elastic", *extra, "--", sys.executable, str(worker)],
        timeout=timeout, capture_output=True, text=True)


def test_supervisor_shrinks_instead_of_failing(tmp_path):
    res = _supervise(tmp_path, (
        "import os, sys\n"
        "n = os.environ['MX_NUM_PROCS']; r = os.environ['MX_PROC_ID']\n"
        "prev = os.environ.get('MX_PREV_NUM_PROCS', '-')\n"
        "print(f'rank {r}/{n} prev {prev} elastic '\n"
        "      f\"{os.environ.get('MX_ELASTIC')} restart \"\n"
        "      f\"{os.environ['MX_RESTART_COUNT']}\", flush=True)\n"
        "if n == '3' and r == '2':\n"
        "    sys.exit(7)\n"
    ), n=3, extra=("--max-restarts", "1"))
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "shrinking gang 3 -> 2" in res.stderr, res.stderr
    assert res.stdout.count("rank 2/3") == 2, res.stdout
    assert "rank 0/2 prev 3 elastic 1 restart 2" in res.stdout, res.stdout
    assert "rank 2/2" not in res.stdout


def test_supervisor_gives_up_at_min_workers(tmp_path):
    res = _supervise(tmp_path, (
        "import os, sys\n"
        "sys.exit(9 if os.environ['MX_PROC_ID'] == '0' else 0)\n"
    ), n=2, extra=("--max-restarts", "0", "--min-workers", "2"))
    assert res.returncode == 9
    assert "giving up" in res.stderr
    assert "attempt 0 (world 2): rank0=9 rank1=" in res.stderr, res.stderr


def test_supervisor_preemption_is_not_a_culprit(tmp_path):
    """Exit 83 is a preemption: the restart says so, and a gang whose
    only non-zero exits are preemptions still counts one culprit."""
    res = _supervise(tmp_path, (
        "import os, sys\n"
        "if os.environ['MX_RESTART_COUNT'] == '0' and "
        "os.environ['MX_PROC_ID'] == '1':\n"
        "    sys.exit(83)\n"
    ), n=2, extra=("--max-restarts", "1"))
    assert res.returncode == 0, res.stderr
    assert "worker preempted (exit 83)" in res.stderr, res.stderr


def test_supervisor_regrows_and_rearms(tmp_path):
    """1 -> 2 -> 3 one rank at a time, a shrink back to 2 and a second
    regrow to the target."""
    marker = tmp_path / "crashed.marker"
    res = _supervise(tmp_path, (
        "import os, sys, time\n"
        "n = os.environ['MX_NUM_PROCS']\n"
        f"marker = {str(marker)!r}\n"
        "print(f\"rank {os.environ['MX_PROC_ID']}/{n} prev \"\n"
        "      f\"{os.environ.get('MX_PREV_NUM_PROCS', '-')}\", flush=True)\n"
        "if n == '3':\n"
        "    if not os.path.exists(marker):\n"
        "        if os.environ['MX_PROC_ID'] == '2':\n"
        "            open(marker, 'w').write('x')\n"
        "            sys.exit(7)\n"
        "        time.sleep(30)\n"
        "    sys.exit(0)\n"
        "time.sleep(60)\n"
    ), n=3, extra=("--max-restarts", "0", "--initial-workers", "1",
                   "--regrow-after", "0.5", "--term-timeout", "2"),
        timeout=120)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "growing gang 1 -> 2" in res.stderr, res.stderr
    assert res.stderr.count("growing gang 2 -> 3") == 2, res.stderr
    assert "growing gang 1 -> 3" not in res.stderr
    assert "shrinking gang 3 -> 2" in res.stderr, res.stderr
    assert "rank 2/3 prev 2" in res.stdout, res.stdout


@pytest.mark.parametrize("args", [
    ["--min-workers", "0"], ["--min-workers", "5"],
    ["--elastic", "--initial-workers", "9"], ["--initial-workers", "2"],
    ["--regrow-after", "5"], ["--max-restarts", "-1"],
    ["--metrics-port", "-1"], ["--serve-port", "-1"],
    ["--launcher", "ssh"]])
def test_cli_validates_its_flags(args):
    res = subprocess.run([sys.executable, LAUNCH, "-n", "3", *args, "--",
                          "true"], capture_output=True, text=True)
    assert res.returncode == 2, (args, res.stderr)


def test_flags_match_the_jax_launcher():
    """Every option of the JAX ``tools/launch.py`` is the port's, with the
    same default."""
    import argparse
    import importlib.util

    def options(path):
        spec = importlib.util.spec_from_file_location("l", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            seen.update({a.dest: (tuple(a.option_strings), a.default)
                         for a in self._actions})
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            mod.main(["-n", "1", "true"])
        except SystemExit:
            pass
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    assert options(LAUNCH) == options(os.path.join(ROOT, "tools",
                                                   "launch.py"))


def test_serve_port_and_restart_exports(tmp_path):
    """--serve-port exports MX_SERVE_PORT; the first incarnation's
    MX_RESTART_COUNT is 0 and no MX_PREV_NUM_PROCS goes out."""
    worker = tmp_path / "w.py"
    worker.write_text(
        "import os\n"
        "print('env', os.environ['MX_SERVE_PORT'], "
        "os.environ['MX_RESTART_COUNT'], "
        "os.environ.get('MX_PREV_NUM_PROCS', '-'), "
        "os.environ['MX_LOCAL_RANK'], flush=True)\n")
    res = subprocess.run([sys.executable, LAUNCH, "-n", "2", "--serve-port",
                          "0", "--", sys.executable, str(worker)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert "[rank 1] env 0 0 - 1" in res.stdout, res.stdout


def _launcher():
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_launch", LAUNCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_culprits_and_the_merged_exposition():
    """A culprit is an exit not in {0, 83, -TERM, -KILL} (at least one);
    the gang exposition regroups each family over the ranks, with an
    ``up`` gauge a rank and the data age of those that answered."""
    import signal

    launch = _launcher()
    assert launch._culprit_count([0, 57, -signal.SIGTERM, 83]) == 1
    assert launch._culprit_count([-signal.SIGKILL, 83]) == 1
    assert launch._culprit_count([1, 7, 0]) == 2
    body = ("# TYPE mx_steps_total counter\n"
            "mx_steps_total{{rank=\"{r}\"}} {n}\n"
            "# TYPE mx_heartbeat_age_seconds gauge\n"
            "mx_heartbeat_age_seconds{{rank=\"{r}\"}} {a}\n# EOF\n")
    text = launch._merge_expositions({
        0: body.format(r=0, n=5, a=1.5), 1: None,
        2: body.format(r=2, n=7, a=0.25)})
    lines = text.splitlines()
    assert lines[:4] == ["# TYPE up gauge", 'up{rank="0"} 1',
                         'up{rank="1"} 0', 'up{rank="2"} 1']
    assert 'mx_scrape_staleness_seconds{rank="2"} 0.25' in lines
    i = lines.index("# TYPE mx_steps_total counter")
    assert lines[i + 1:i + 3] == ['mx_steps_total{rank="0"} 5',
                                  'mx_steps_total{rank="2"} 7']
    assert lines[-1] == "# EOF" and text.count("# EOF") == 1


def test_flight_tail_collapses_spans(tmp_path):
    """A rank's flight-recorder tail: a begin/end pair is one span line,
    an open span stays (where the rank died), clock anchors go."""
    launch = _launcher()
    events = [{"t": 1.0, "kind": "clock_anchor", "mono": 0.0},
              {"t": 1.0, "kind": "span_begin", "span": 1, "name": "step",
               "rank": 0},
              {"t": 1.5, "kind": "span_end", "span": 1, "name": "step",
               "rank": 0, "dur_ms": 500.0},
              {"t": 2.0, "kind": "span_begin", "span": 2,
               "name": "checkpoint_save", "rank": 0}]
    (tmp_path / "rank-0.jsonl").write_text(
        "".join(json.dumps(e) + "\n" for e in events))
    tail = [json.loads(t) for t in launch._flight_tail(str(tmp_path), 0)]
    assert [(e["kind"], e["name"]) for e in tail] == [
        ("span", "step"), ("span_begin", "checkpoint_save")]
    assert tail[0]["dur_ms"] == 500.0
