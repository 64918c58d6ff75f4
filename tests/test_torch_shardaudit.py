"""The port's placement audit (``dexiraft_tpu_torch.analysis.shardaudit``)
against the JAX package's goldens.

JAX's ``dexiraft_tpu/analysis/layout_golden{,_fsdp,_halo}.json`` are read
as JSON (nothing of JAX is imported): the port's ``train_fsdp`` and
``train_halo`` state groups equal JAX's (``[0].params`` whole; the Adam
moments plus JAX's two int32 counts make JAX's ``[0].opt_state``), their
batch groups equal JAX's ``P('data', 'seq')`` entries (the fsdp leg on
JAX's data 2 x fsdp 2 x seq 2 mesh, the fence step on row slabs), the
fence ``train`` leg on data 4 x seq 2 equals JAX's ``train`` section the
same way (state, batch, metrics: the port's ``lr`` a Python float at 8
bytes), the fence ``eval`` leg equals JAX's ``eval`` section group by
group, the serve legs (the data-parallel eval step, the streaming encode
and refine steps on 8 CPU entries) equal JAX's ``serve``,
``serve_encode`` and ``serve_refine`` sections group by group, and every
declared group's spec, megabytes and replication equal JAX's. The CLI passes on the
shipped goldens and exits nonzero on a changed spec (in a train golden
and in the serve golden), a vanished group, a new group and a replicated
100 MB group.
"""

import copy
import json
import os

import pytest

from dexiraft_tpu_torch.analysis import shardaudit
from test_torch_train_ops import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GOLDENS = os.path.join(REPO, "dexiraft_tpu", "analysis")
LEGS = ["fsdp", "halo"]
SERVE_STEPS = ["serve", "serve_encode", "serve_refine"]


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    yield


def _file(leg):
    return ("layout_golden.json" if leg == "serve"
            else f"layout_golden_{leg}.json")


def _golden(leg, jax=False):
    """A leg's golden ("fsdp", "halo", or "serve": layout_golden.json)."""
    where = JAX_GOLDENS if jax else os.path.dirname(shardaudit.__file__)
    with open(os.path.join(where, _file(leg))) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def reports():
    return {leg: shardaudit.run_audit(leg) for leg in LEGS}


@pytest.mark.parametrize("leg", LEGS)
def test_report_equals_the_shipped_golden(reports, leg):
    assert shardaudit.diff_golden(reports[leg], _golden(leg)) == []
    assert shardaudit.flagged_groups(reports[leg]) == []


@pytest.mark.parametrize("io", ["in", "out"])
@pytest.mark.parametrize("leg", LEGS)
def test_state_groups_equal_jax(leg, io):
    port = _golden(leg)["steps"][f"train_{leg}"][io]
    jax = _golden(leg, jax=True)["steps"][f"train_{leg}"][io]
    _hold_state_groups(port, jax, _golden(leg), [
        "P()", "P(None, None, 'fsdp', None)", "P(None, None, None, 'fsdp')"])


def _hold_state_groups(port, jax, golden, specs):
    """A train leg's state groups against JAX's, through the golden's
    header (``opt_state_scalars``, ``renamed_from_jax``)."""
    assert port["[0].params"] == jax["[0].params"]
    assert port["[0].params"]["leaves"] == 106
    assert port["[0].params"]["bytes"] == 3_960_648
    assert port["[0].params"]["specs"] == specs
    # JAX's opt_state: the two moments of every parameter plus optax's
    # two int32 counts; the port's one count is its own group
    scalars = golden["opt_state_scalars"]
    moments, want = port["[0].opt_state"], jax["[0].opt_state"]
    assert moments["specs"] == want["specs"]
    assert moments["max_leaf_bytes"] == want["max_leaf_bytes"]
    assert moments["leaves"] == 2 * port["[0].params"]["leaves"]
    assert moments["bytes"] == 2 * port["[0].params"]["bytes"]
    assert moments["leaves"] + scalars["jax_scalar_leaves"] == \
        want["leaves"] == 214
    assert moments["bytes"] + scalars["jax_scalar_bytes"] == \
        want["bytes"] == 7_921_304
    assert port["[0].opt_count"]["specs"] == ["P()"]
    # renamed: JAX's rng key is the port's generator state
    assert golden["renamed_from_jax"] == {"[0].rng": "[0].generator"}
    for jax_name, name in golden["renamed_from_jax"].items():
        assert port[name]["specs"] == jax[jax_name]["specs"] == ["P()"]
    assert port["[0].step"]["specs"] == jax["[0].step"]["specs"]
    state = {k for k in port if k.startswith("[0]")}
    assert state == {"[0].params", "[0].opt_state", "[0].opt_count",
                     "[0].generator", "[0].step"}


def test_halo_batch_groups_equal_jax():
    port = _golden("halo")["steps"]["train_halo"]["in"]
    jax = _golden("halo", jax=True)["steps"]["train_halo"]["in"]
    batch = sorted(k for k in jax if k.startswith("[1]"))
    assert batch == ["[1]['flow']", "[1]['image1']", "[1]['image2']",
                     "[1]['valid']"]
    for key in batch:
        assert jax[key]["specs"] == ["P('data', 'seq')"]
        assert port[key] == jax[key], key


BATCH = ("[1]['flow']", "[1]['image1']", "[1]['image2']", "[1]['valid']")


def test_fsdp_leg_batch_is_split_over_data_only():
    """The fence step's rows on JAX's fsdp leg mesh (data 2, fsdp 2, seq
    2): the data axis cuts the batch's rows and, since the fence step
    runs on row slabs, the seq axis its image rows, as JAX's leg."""
    port = _golden("fsdp")["steps"]["train_fsdp"]
    jax = _golden("fsdp", jax=True)["steps"]["train_fsdp"]
    assert port["mesh"] == jax["mesh"] == {"data": 2, "fsdp": 2, "seq": 2}
    for key in BATCH:
        assert port["in"][key]["specs"] == ["P('data', 'seq')"]
        assert port["in"][key] == jax["in"][key], key


def _hold_metric_groups(port, jax):
    """The train step's metric groups against JAX's: equal, but for the
    port's lr, a Python float counted at 8 bytes (JAX's an f32 array)."""
    metrics = sorted(k for k in jax if k.startswith("[1]"))
    assert metrics == sorted(k for k in port if k.startswith("[1]"))
    assert len(metrics) == 7
    for key in metrics:
        want = dict(jax[key])
        if key == "[1]['lr']":
            want.update(bytes=shardaudit.METRIC_BYTES["lr"],
                        max_leaf_bytes=shardaudit.METRIC_BYTES["lr"])
        assert port[key] == want, key


@pytest.mark.parametrize("leg", LEGS)
def test_train_legs_metric_groups_equal_jax(leg):
    _hold_metric_groups(_golden(leg)["steps"][f"train_{leg}"]["out"],
                        _golden(leg, jax=True)["steps"][f"train_{leg}"]["out"])


@pytest.mark.parametrize("io", ["in", "out"])
def test_fence_train_leg_equals_jax(io):
    """The fence train step on JAX's train mesh (data 4 x seq 2): the
    state replicated (no fsdp axis), the batch over (data, seq), the
    metrics replicated, group by group JAX's ``train`` section."""
    port, jax = _golden("serve"), _golden("serve", jax=True)
    mine, want = port["steps"]["train"], jax["steps"]["train"]
    assert mine["mesh"] == want["mesh"] == {"data": 4, "seq": 2}
    _hold_state_groups(mine[io], want[io], port, ["P()"])
    if io == "in":
        for key in BATCH:
            assert want[io][key]["specs"] == ["P('data', 'seq')"]
            assert mine[io][key] == want[io][key], key
    else:
        _hold_metric_groups(mine[io], want[io])


@pytest.mark.parametrize("io", ["in", "out"])
def test_fence_eval_leg_equals_jax(io):
    """The fence eval step on data 4 x seq 2, production config (v1
    small on B1): the whole parameters on every rank, image1, image2,
    flow_init and both flows over (data, seq), group by group JAX's
    ``eval`` section under its positional names."""
    port, jax = _golden("serve"), _golden("serve", jax=True)
    mine, want = port["steps"]["eval"], jax["steps"]["eval"]
    assert mine["mesh"] == want["mesh"] == {"data": 4, "seq": 2}
    assert mine[io] == want[io]
    assert set(mine[io]) == set(port["positional_names"]["eval"][io])
    rows = [k for k in mine[io] if k != "[0]['params']"]
    assert all(mine[io][k]["specs"] == ["P('data', 'seq')"] for k in rows)


@pytest.mark.parametrize("leg", LEGS)
def test_declared_groups_equal_jax(leg):
    port, jax = _golden(leg)["declared"], _golden(leg, jax=True)["declared"]
    assert port.keys() == jax.keys()
    for name, want in jax.items():
        for field in ("spec", "total_mb", "per_device_mb", "replicated",
                      "flagged"):
            assert port[name][field] == want[field], (name, field)


def test_plans_pin_the_production_leaf_policy():
    plans = _golden("fsdp")["plans"]
    assert sorted(plans) == ["v1@2", "v1@4", "v5@2", "v5@4"]
    for name, plan in plans.items():
        assert plan["layout"]["n_fsdp"] == int(name.split("@")[1])
        assert plan["layout"]["dims"]
        assert "P()" in plan["params"]["specs"]


@pytest.fixture(scope="module")
def serve_report():
    return shardaudit.run_audit("serve")


def test_serve_report_equals_the_shipped_golden(serve_report):
    assert sorted(serve_report["steps"]) == sorted(SERVE_STEPS
                                                   + ["eval", "train"])
    assert shardaudit.diff_golden(serve_report, _golden("serve")) == []
    assert shardaudit.flagged_groups(serve_report) == []


@pytest.mark.parametrize("io", ["in", "out"])
@pytest.mark.parametrize("step", SERVE_STEPS)
def test_serve_sections_equal_jax(step, io):
    """Group by group JAX's, under JAX's positional names: no serve
    section carries a group the golden renames (its header's renames are
    the train leg's), and its header names the port argument behind
    each."""
    port, jax = _golden("serve"), _golden("serve", jax=True)
    renamed = set(port["renamed_from_jax"]) | set(
        port["renamed_from_jax"].values())
    assert not renamed & set(port["steps"][step][io])
    assert port["steps"][step]["mesh"] == jax["steps"][step]["mesh"] == \
        {"data": 8}
    mine, want = port["steps"][step][io], jax["steps"][step][io]
    assert mine == want
    assert set(mine) <= set(port["positional_names"][step][io])


def test_serve_groups_hold_jax_figures():
    steps = _golden("serve")["steps"]
    serve = steps["serve"]
    assert serve["in"]["[0]['params']"] == {
        "specs": ["P()"], "leaves": 106, "bytes": 3_960_648,
        "max_leaf_bytes": 836_352}
    for key, nbytes in (("[1]", 294_912), ("[2]", 294_912), ("[5]", 3_072)):
        assert serve["in"][key]["specs"] == ["P('data')"]
        assert serve["in"][key]["bytes"] == nbytes
    assert [serve["out"][k]["bytes"] for k in ("[0]", "[1]")] == [
        3_072, 196_608]
    encode = steps["serve_encode"]
    assert encode["in"]["[0]['params']"]["leaves"] == 88
    assert encode["in"]["[0]['params']"]["bytes"] == 454_528
    assert encode["out"]["['ctx']"]["bytes"] == 245_760
    assert encode["out"]["['fmap']"]["bytes"] == 196_608
    refine = steps["serve_refine"]
    assert refine["in"]["[0]['params']"]["leaves"] == 18
    assert refine["in"]["[0]['params']"]["bytes"] == 3_506_120
    # refine reads features2's fmap only, as JAX's step keeps it
    assert sorted(refine["in"]) == ["[0]['params']", "[1]['ctx']",
                                    "[1]['fmap']", "[2]['fmap']", "[3]"]


def test_serve_declared_groups_equal_jax():
    port = _golden("serve")["declared"]
    jax = _golden("serve", jax=True)["declared"]
    assert port == jax
    assert port["batch"]["spec"] == "P('data', 'seq')"


def test_cli_passes_on_the_shipped_goldens(capsys):
    assert shardaudit.main([]) == 0
    out = capsys.readouterr().out
    for leg in LEGS + ["serve"]:
        assert f"[{leg}] 0 drift line(s), 0 flagged group(s)" in out


def _mutated(tmp_path, mutate, leg_of=("halo", "train_halo")):
    for leg in LEGS + ["serve"]:
        golden = _golden(leg)
        if leg == leg_of[0]:
            mutate(golden["steps"][leg_of[1]]["in"])
        with open(tmp_path / _file(leg), "w") as f:
            json.dump(golden, f)
    return ["--golden_dir", str(tmp_path)]


def _spec_change(groups):
    groups["[0].params"]["specs"] = ["P()"]


def _vanished(groups):  # the golden holds a group the audit no longer sees
    groups["[0].rng"] = copy.deepcopy(groups["[0].step"])


def _new_group(groups):  # the audit sees a group the golden lacks
    del groups["[0].opt_count"]


@pytest.mark.parametrize("mutate, says", [
    (_spec_change, "train_halo.in.[0].params: golden"),
    (_vanished, "train_halo.in.[0].rng: vanished"),
    (_new_group, "train_halo.in.[0].opt_count: new group"),
])
def test_cli_exits_nonzero_on_drift(tmp_path, capsys, mutate, says):
    assert shardaudit.main(_mutated(tmp_path, mutate)) == 1
    out = capsys.readouterr().out
    assert says in out
    assert "[fsdp] 0 drift line(s)" in out


def test_cli_flags_a_changed_spec_in_the_serve_golden(tmp_path, capsys):
    def mutate(groups):
        groups["[1]"]["specs"] = ["P()"]

    assert shardaudit.main(_mutated(tmp_path, mutate,
                                    ("serve", "serve"))) == 1
    out = capsys.readouterr().out
    assert "[serve] DRIFT steps.serve.in.[1]: golden" in out
    assert "[serve] 1 drift line(s)" in out
    assert "[halo] 0 drift line(s)" in out


def test_cli_exits_nonzero_on_a_replicated_100mb_group(tmp_path, capsys,
                                                       monkeypatch):
    """A declared group of 100 MB that resolves replicated and is not in
    REPLICATED_OK trips the wire (and a golden regenerated with it still
    fails: a flag is never written away)."""
    from dexiraft_tpu_torch.parallel import layout

    entries, spec = shardaudit.declared_entries, layout.group_spec
    monkeypatch.setattr(shardaudit, "declared_entries", lambda halo: (
        entries(halo) + [("replicated_copy", 100 * 2**20)]))
    monkeypatch.setattr(layout, "group_spec", lambda group, axes: (
        () if group == "replicated_copy" else spec(group, axes)))
    report = shardaudit.run_audit("fsdp")
    assert report["declared"]["replicated_copy"]["flagged"]
    assert shardaudit.flagged_groups(report) == [
        "declared.replicated_copy: 100.0 MB resolves fully replicated "
        "(spec P()): shard it or pin it in parallel.layout.REPLICATED_OK"]
    assert shardaudit.main(["--write", "--golden_dir", str(tmp_path)]) == 1
    assert shardaudit.main(["--golden_dir", str(tmp_path)]) == 1
    assert "FLAGGED declared.replicated_copy" in capsys.readouterr().out
