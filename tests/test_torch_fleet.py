"""The port's multi-tenant fleet (``isoforest_tpu_torch/fleet``) on the CPU:
``tests/test_fleet.py`` against the port, then the same tenants and the same
request sequence through both packages.

* The registry is lazy, loads resume from the sealed directories, and each
  tenant's scores are its ``model.score``; the byte-budgeted LRU respects
  the budget and recency, a tenant mid-refit is pinned, and a reload after
  an eviction scores bit for bit as before.
* ``fail_fleet_load`` answers a typed 503 on the ``fleet_load_failed`` rung
  while other tenants serve; ``evict_during_score`` drains the request's
  flush on the ``fleet_evict_under_load`` rung.
* ``POST /score/<model_id>``, ``POST /reload/<model_id>`` and
  ``GET /models`` over real HTTP (each request with its own timeout), and
  one tenant's stalled swap and full queue leave another's answers exact.
* Residency bytes: on the CPU the JAX package's count, so the eviction
  order is the JAX package's for the same sequence (the parity test); on
  the card the bytes the tenant holds there (a pinned difference, tested
  here with the registry's device test stood in).

Scores of the two packages agree within 2e-6 (their float32 ``c(n)``
differs by a few ulps). No real sleeps: swaps are event-gated and HTTP
requests block on their own response. The JAX package's CLI cases wait for
the port's CLI.
"""

from __future__ import annotations

import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from isoforest_tpu_torch import IsolationForest, load_model, telemetry
from isoforest_tpu_torch.fleet import (
    FleetService,
    ModelLoadError,
    ModelRegistry,
    UnknownModelError,
    discover_models,
    held_nbytes,
    layout_nbytes,
    mount_fleet,
    serve_fleet,
)
from isoforest_tpu_torch.fleet import registry as _registry_mod
from isoforest_tpu_torch.ops.scoring_layout import layout_nbytes as tables_nbytes
from isoforest_tpu_torch.ops.traversal import scoring_tables
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import degradation_report, reset_degradations
from isoforest_tpu_torch.serving import ServingConfig
from isoforest_tpu_torch.telemetry import resources
from isoforest_tpu_torch.telemetry.http import MetricsServer

N_TREES = 10
TENANTS = ("tenant-a", "tenant-b", "tenant-c")
HTTP_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    reset_degradations()
    yield
    telemetry.reset()
    reset_degradations()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(4096, 5)).astype(np.float32)
    X[:80] += 4.0
    return X


@pytest.fixture(scope="module")
def fleet_dirs(data, tmp_path_factory):
    """Three sealed tenant directories (distinct seeds, distinct scores)
    and the fitted models."""
    root = tmp_path_factory.mktemp("fleet-models")
    out = {}
    for i, model_id in enumerate(TENANTS):
        model = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=i + 1, device="cpu").fit(data)
        path = str(root / model_id)
        model.save(path)
        out[model_id] = (path, model)
    return out


def _score(model, rows):
    return model.score(rows).numpy()


def _fast_config(**kw):
    kw.setdefault("linger_ms", 0.0)
    kw.setdefault("request_timeout_s", 120.0)
    return ServingConfig(**kw)


def _registry(fleet_dirs, tmp_path, ids=TENANTS[:2], **kw):
    kw.setdefault("config", _fast_config())
    registry = ModelRegistry(device="cpu", **kw)
    for model_id in ids:
        registry.register(model_id, fleet_dirs[model_id][0], work_dir=str(tmp_path / f"wd-{model_id}"))
    return registry


def _gauge_value(name):
    metric = telemetry.snapshot()["metrics"].get(name)
    assert metric and metric["series"], f"gauge {name} has no series"
    return metric["series"][0]["value"]


class TestRegistryBasics:
    def test_register_is_lazy_and_first_score_loads(self, fleet_dirs, tmp_path, data):
        registry = _registry(fleet_dirs, tmp_path)
        try:
            assert all(not e["resident"] for e in registry.models_state())
            assert not telemetry.get_events(kind="fleet.load")
            scores = registry.score("tenant-a", data[:32])
            np.testing.assert_array_equal(scores, _score(fleet_dirs["tenant-a"][1], data[:32]))
            entry = registry.entry("tenant-a")
            assert entry.resident and entry.loads == 1
            assert entry.model.device.type == "cpu"
            assert entry.resident_bytes == layout_nbytes(entry.model)
            loads = telemetry.get_events(kind="fleet.load")
            assert len(loads) == 1
            assert loads[0].fields["model_id"] == "tenant-a"
            assert loads[0].fields["bytes"] == entry.resident_bytes
            assert not registry.entry("tenant-b").resident
        finally:
            registry.close()

    def test_tenants_score_their_own_model(self, fleet_dirs, tmp_path, data):
        registry = _registry(fleet_dirs, tmp_path)
        try:
            sa = registry.score("tenant-a", data[:64])
            sb = registry.score("tenant-b", data[:64])
            np.testing.assert_array_equal(sa, _score(fleet_dirs["tenant-a"][1], data[:64]))
            np.testing.assert_array_equal(sb, _score(fleet_dirs["tenant-b"][1], data[:64]))
            assert not np.array_equal(sa, sb)
        finally:
            registry.close()

    def test_unknown_id_and_bad_registrations(self, fleet_dirs, tmp_path):
        registry = _registry(fleet_dirs, tmp_path)
        try:
            with pytest.raises(UnknownModelError) as exc:
                registry.score("nope", np.zeros((1, 5), np.float32))
            assert exc.value.status == 404
            with pytest.raises(ValueError, match="already registered"):
                registry.register("tenant-a", fleet_dirs["tenant-a"][0])
            with pytest.raises(ValueError, match="model_id"):
                registry.register("bad/id", fleet_dirs["tenant-a"][0])
            with pytest.raises(FileNotFoundError):
                registry.register("ghost", str(tmp_path / "missing"))
            with pytest.raises(ValueError, match="budget_bytes"):
                ModelRegistry(budget_bytes=0)
        finally:
            registry.close()

    def test_close_evicts_everything(self, fleet_dirs, tmp_path, data):
        registry = _registry(fleet_dirs, tmp_path)
        registry.score("tenant-a", data[:16])
        registry.score("tenant-b", data[:16])
        registry.close()
        assert all(not e["resident"] for e in registry.models_state())
        evicts = telemetry.get_events(kind="fleet.evict")
        assert sorted(e.fields["model_id"] for e in evicts) == ["tenant-a", "tenant-b"]
        assert all(e.fields["cause"] == "close" for e in evicts)
        with pytest.raises(RuntimeError, match="closed"):
            registry.register("tenant-c", fleet_dirs["tenant-c"][0])


class TestResidencyLRU:
    def test_eviction_strictly_respects_byte_budget(self, fleet_dirs, tmp_path, data):
        budget = int(layout_nbytes(fleet_dirs["tenant-a"][1]) * 1.5)  # one resident model
        registry = _registry(fleet_dirs, tmp_path, budget_bytes=budget)
        try:
            registry.score("tenant-a", data[:16])
            registry.score("tenant-b", data[:16])
            state = registry.state()
            assert state["resident_bytes"] <= budget
            assert state["resident_models"] == 1
            assert not registry.entry("tenant-a").resident
            assert registry.entry("tenant-b").resident
            evicts = telemetry.get_events(kind="fleet.evict")
            assert [(e.fields["model_id"], e.fields["cause"]) for e in evicts] == [("tenant-a", "budget")]
        finally:
            registry.close()

    def test_lru_order_respects_recency(self, fleet_dirs, tmp_path, data):
        one = layout_nbytes(fleet_dirs["tenant-a"][1])
        registry = _registry(fleet_dirs, tmp_path, ids=TENANTS, budget_bytes=int(one * 2.2))
        try:
            registry.score("tenant-a", data[:16])
            registry.score("tenant-b", data[:16])
            registry.score("tenant-a", data[:16])  # a is now newer than b
            registry.score("tenant-c", data[:16])
            assert registry.entry("tenant-a").resident
            assert not registry.entry("tenant-b").resident
            assert registry.entry("tenant-c").resident
        finally:
            registry.close()

    def test_resident_bytes_gauge_matches_packed_accounting(self, fleet_dirs, tmp_path, data):
        registry = _registry(fleet_dirs, tmp_path)
        try:
            registry.score("tenant-a", data[:16])
            registry.score("tenant-b", data[:16])
            expected = sum(layout_nbytes(registry.entry(t).model) for t in TENANTS[:2])
            assert registry.state()["resident_bytes"] == expected
            assert _gauge_value("isoforest_fleet_resident_bytes") == expected
            assert _gauge_value("isoforest_fleet_resident_models") == 2
            registry.evict("tenant-a")
            assert _gauge_value("isoforest_fleet_resident_bytes") == layout_nbytes(registry.entry("tenant-b").model)
            assert _gauge_value("isoforest_fleet_resident_models") == 1
            assert registry.evict("tenant-a") is False, "not resident: nothing to evict"
        finally:
            registry.close()

    def test_reload_after_eviction_is_bitwise_identical(self, fleet_dirs, tmp_path, data):
        registry = _registry(fleet_dirs, tmp_path)
        try:
            before = registry.score("tenant-a", data[:256])
            assert registry.evict("tenant-a")
            assert not registry.entry("tenant-a").resident
            after = registry.score("tenant-a", data[:256])
            np.testing.assert_array_equal(before, after)
            assert registry.entry("tenant-a").loads == 2
        finally:
            registry.close()


class TestPlaneBudget:
    def test_cpu_accounts_host_plane_bytes(self, fleet_dirs, tmp_path, data):
        resources.reset_resources()
        registry = _registry(fleet_dirs, tmp_path)
        try:
            registry.score("tenant-a", data[:16])
            entry = registry.entry("tenant-a")
            assert entry.plane_bytes["placement"] == "host"
            planes = telemetry.resident_plane_bytes()
            assert planes["host"] == entry.resident_bytes
            assert planes["device"] == 0
            assert telemetry.get_events(kind="fleet.load")[-1].fields["placement"] == "host"
        finally:
            registry.close()
        assert telemetry.resident_plane_bytes()["models"] == {}

    def test_device_placement_evicts_on_device_bytes_and_reloads_bitwise(self, fleet_dirs, tmp_path, data,
                                                                          monkeypatch):
        """With the plane placed on a device, those bytes are what the
        budget bounds (the JAX package's count, as on its accelerator)."""
        monkeypatch.setattr(resources, "plane_placement", lambda platform=None: "device")
        resources.reset_resources()
        one = layout_nbytes(fleet_dirs["tenant-a"][1])
        registry = _registry(fleet_dirs, tmp_path, budget_bytes=int(one * 1.5))
        try:
            before = registry.score("tenant-a", data[:256])
            entry = registry.entry("tenant-a")
            assert entry.plane_bytes["placement"] == "device"
            assert entry.resident_bytes == entry.plane_bytes["device"] == one
            assert telemetry.resident_plane_bytes()["device"] == one
            registry.score("tenant-b", data[:16])
            assert not registry.entry("tenant-a").resident
            planes = telemetry.resident_plane_bytes()
            assert planes["device"] == one and list(planes["models"]) == ["tenant-b"]
            evict = telemetry.get_events(kind="fleet.evict")[-1]
            assert (evict.fields["model_id"], evict.fields["cause"]) == ("tenant-a", "budget")
            np.testing.assert_array_equal(before, registry.score("tenant-a", data[:256]))
        finally:
            registry.close()
        assert telemetry.resident_plane_bytes() == {"host": 0, "device": 0, "models": {}}

    def test_evict_mid_retrain_refused_until_swap_completes(self, fleet_dirs, tmp_path, data):
        swap_entered, swap_release = threading.Event(), threading.Event()

        def slow_swap():
            swap_entered.set()
            assert swap_release.wait(timeout=300)

        fc = faults.FakeClock()
        registry = ModelRegistry(config=_fast_config(), device="cpu")
        registry.register("tenant-a", fleet_dirs["tenant-a"][0], work_dir=str(tmp_path / "wd-a"), manager_kwargs={
            "auto_retrain": False, "background": True, "checkpoint_every": 4, "clock": fc.now, "sleep": fc.sleep,
            "hooks": {"mid_swap": slow_swap},
        })
        try:
            for i in range(4):
                registry.score("tenant-a", data[i * 512 : (i + 1) * 512])
            entry = registry.entry("tenant-a")
            assert entry.manager is not None
            assert entry.manager.retrain(reason="pin-test", wait=False)
            assert swap_entered.wait(timeout=300)
            assert entry.pinned
            assert registry.evict("tenant-a") is False
            refused = telemetry.get_events(kind="fleet.evict_refused")
            assert len(refused) == 1 and refused[0].fields["reason"] == "retrain_in_progress"
            assert entry.resident
            swap_release.set()
            assert entry.manager.wait_retrain(timeout_s=300)
            assert entry.manager.generation == 2
            assert registry.evict("tenant-a") is True
            # the reload resumes the swapped generation from CURRENT.json
            reloaded = registry.score("tenant-a", data[:128])
            fresh = registry.entry("tenant-a")
            assert fresh.generation == 2
            np.testing.assert_array_equal(reloaded, _score(fresh.manager.model, data[:128]))
        finally:
            swap_release.set()
            registry.close()


class TestQuantizedResidency:
    def test_quantized_tenants_fit_where_f32_twins_evict(self, data, tmp_path):
        model = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=9, device="cpu").fit(data)
        f32_paths = [str(tmp_path / f"f32-{i}") for i in range(2)]
        for p in f32_paths:
            model.save(p)
        f32_bytes = layout_nbytes(model)
        model.set_scoring_representation("q16")
        q16_bytes = layout_nbytes(model)
        q16_paths = [str(tmp_path / f"q16-{i}") for i in range(2)]
        for p in q16_paths:
            model.save(p)
        assert f32_bytes / q16_bytes >= 1.8, (f32_bytes, q16_bytes)
        budget = int(f32_bytes * 1.2)
        assert 2 * q16_bytes <= budget < 2 * f32_bytes
        reg_q = ModelRegistry(config=_fast_config(), budget_bytes=budget, device="cpu")
        reg_f = ModelRegistry(config=_fast_config(), budget_bytes=budget, device="cpu")
        for i in range(2):
            reg_q.register(f"q{i}", q16_paths[i], work_dir=str(tmp_path / f"wd-q{i}"))
            reg_f.register(f"f{i}", f32_paths[i], work_dir=str(tmp_path / f"wd-f{i}"))
        try:
            want = _score(model, data[:64])
            for i in range(2):
                np.testing.assert_array_equal(reg_q.score(f"q{i}", data[:64]), want)
            for i in range(2):
                entry = reg_q.entry(f"q{i}")
                assert entry.resident and entry.model.scoring_representation == "q16"
                assert entry.resident_bytes == q16_bytes
            assert reg_q.state()["resident_bytes"] == 2 * q16_bytes <= budget
            for i in range(2):
                np.testing.assert_array_equal(reg_f.score(f"f{i}", data[:64]), want)
            assert not reg_f.entry("f0").resident
            assert reg_f.entry("f1").resident
            evicted = [e.fields["model_id"] for e in telemetry.get_events(kind="fleet.evict")
                       if e.fields["cause"] == "budget"]
            assert evicted == ["f0"]
        finally:
            reg_q.close()
            reg_f.close()


class TestCardResidency:
    """The pinned difference: on the card the budget counts the bytes a
    tenant holds there once warmed (its forest and every table in its
    model's cache), recounted after each request; the JAX package counts
    its own layout. The card is stood in for by the registry's device
    test, so the CPU model takes the card's accounting."""

    @pytest.fixture()
    def as_if_on_the_card(self, monkeypatch):
        monkeypatch.setattr(_registry_mod, "_counts_held_tables", lambda model: True)

    def test_held_nbytes_counts_the_forest_and_each_cached_table(self, fleet_dirs):
        model = load_model(fleet_dirs["tenant-a"][0], device="cpu")
        forest = sum(a.numel() * a.element_size() for a in model.forest)
        assert held_nbytes(model) == forest
        walk = scoring_tables(model.forest, "walk", model.device, model._cache)
        dense = scoring_tables(model.forest, "dense", model.device, model._cache)
        assert held_nbytes(model) == forest + tables_nbytes(walk) + tables_nbytes(dense)
        assert held_nbytes(model) != layout_nbytes(model)

    def test_a_card_tenant_counts_its_warmed_tables(self, fleet_dirs, tmp_path, data, as_if_on_the_card):
        resources.reset_resources()
        registry = _registry(fleet_dirs, tmp_path)
        try:
            np.testing.assert_array_equal(registry.score("tenant-a", data[:64]),
                                          _score(fleet_dirs["tenant-a"][1], data[:64]))
            entry = registry.entry("tenant-a")
            # loading warmed the service's bucket: the walk's tables are held
            assert ("walk", entry.model.device) in entry.model._cache
            assert entry.resident_bytes == held_nbytes(entry.model)
            assert entry.plane_bytes == {"host": 0, "device": entry.resident_bytes, "plane": "f32",
                                         "placement": "device"}
            assert telemetry.resident_plane_bytes()["device"] == entry.resident_bytes
            assert telemetry.get_events(kind="fleet.load")[-1].fields["bytes"] == entry.resident_bytes
        finally:
            registry.close()

    def test_tables_built_later_are_counted_and_enforce_the_budget(self, fleet_dirs, tmp_path, data,
                                                                   as_if_on_the_card):
        """A tenant whose cache grows (``auto`` built another strategy's
        tables) is recounted after its next request, and the budget evicts
        the least recently used other tenant."""
        registry = _registry(fleet_dirs, tmp_path)
        try:
            registry.score("tenant-a", data[:16])
            registry.score("tenant-b", data[:16])
            a, b = registry.entry("tenant-a"), registry.entry("tenant-b")
            registry.budget_bytes = a.resident_bytes + b.resident_bytes + 1
            scoring_tables(b.model.forest, "dense", b.model.device, b.model._cache)
            registry.score("tenant-b", data[:16])
            assert b.resident_bytes == held_nbytes(b.model)
            assert not a.resident, "the recount pushed the fleet past its budget"
            assert registry.state()["resident_bytes"] == b.resident_bytes
            evict = telemetry.get_events(kind="fleet.evict")[-1]
            assert (evict.fields["model_id"], evict.fields["cause"]) == ("tenant-a", "budget")
        finally:
            registry.close()


class TestFaultSeams:
    def test_fail_fleet_load_refuses_503_others_serve(self, fleet_dirs, tmp_path, data):
        registry = _registry(fleet_dirs, tmp_path)
        try:
            with faults.inject(fail_fleet_load="tenant-a"):
                with pytest.raises(ModelLoadError) as exc:
                    registry.score("tenant-a", data[:8])
                assert exc.value.status == 503 and exc.value.retry_after_s == 1.0
                assert degradation_report().count("fleet_load_failed") == 1
                assert "FaultInjectedError" in registry.entry("tenant-a").last_load_error
                np.testing.assert_array_equal(registry.score("tenant-b", data[:8]),
                                              _score(fleet_dirs["tenant-b"][1], data[:8]))
            np.testing.assert_array_equal(registry.score("tenant-a", data[:8]),
                                          _score(fleet_dirs["tenant-a"][1], data[:8]))
            assert registry.entry("tenant-a").last_load_error is None
        finally:
            registry.close()

    def test_evict_during_score_drains_bitwise(self, fleet_dirs, tmp_path, data):
        registry = _registry(fleet_dirs, tmp_path, config=_fast_config(batch_rows=4096, linger_ms=60_000.0,
                                                                       max_queue_rows=8192))
        try:
            with faults.inject(evict_during_score=True):
                scores = registry.score("tenant-a", data[:64])
            np.testing.assert_array_equal(scores, _score(fleet_dirs["tenant-a"][1], data[:64]))
            assert degradation_report().count("fleet_evict_under_load") == 1
            assert not registry.entry("tenant-a").resident
            evicts = telemetry.get_events(kind="fleet.evict")
            assert evicts and evicts[-1].fields["cause"] == "fault_injected"
            np.testing.assert_array_equal(registry.score("tenant-a", data[:4096]),
                                          _score(fleet_dirs["tenant-a"][1], data[:4096]))
            assert registry.entry("tenant-a").loads == 2
        finally:
            registry.close()

    def test_both_seams_are_known_faults(self):
        assert {"fail_fleet_load", "evict_during_score"} <= faults.KNOWN_FAULTS
        faults.check_fleet_load("x")
        assert not faults.evict_during_score()
        with faults.inject(fail_fleet_load="y"):
            faults.check_fleet_load("x")  # another tenant's fault
            with pytest.raises(faults.FaultInjectedError):
                faults.check_fleet_load("y")


def _post(url, path, payload, content_type="application/json"):
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=body, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=HTTP_TIMEOUT_S) as resp:
        return json.loads(resp.read())


@pytest.fixture()
def served_fleet(fleet_dirs, tmp_path):
    handle = serve_fleet(models={t: fleet_dirs[t][0] for t in TENANTS[:2]}, port=0, config=_fast_config(),
                         work_root=str(tmp_path / "work"), device="cpu")
    yield handle
    handle.close()


class TestHTTPFleet:
    def test_each_tenant_route_scores_its_own_model(self, served_fleet, fleet_dirs, data):
        for model_id in TENANTS[:2]:
            status, body = _post(served_fleet.url, f"/score/{model_id}",
                                 {"rows": [[float(v) for v in r] for r in data[:5]]})
            assert status == 200, body
            doc = json.loads(body)
            assert doc["model_id"] == model_id
            assert doc["scores"] == [float(s) for s in _score(fleet_dirs[model_id][1], data[:5])]
            assert doc["generation"] == 1 and doc["flush_rows"] >= 5
            assert doc["predictions"] == [0.0] * 5

    def test_unknown_model_id_is_json_404_naming_models(self, served_fleet):
        status, body = _post(served_fleet.url, "/score/ghost", {"row": [1.0, 2.0, 3.0, 4.0, 5.0]})
        assert status == 404
        doc = json.loads(body)
        assert doc["status"] == 404 and doc["model_id"] == "ghost"
        assert doc["models"] == ["tenant-a", "tenant-b"]

    def test_csv_per_tenant(self, served_fleet, fleet_dirs, data):
        body = "\n".join(",".join(repr(float(v)) for v in r) for r in data[:3]).encode()
        status, out = _post(served_fleet.url, "/score/tenant-b", body, content_type="text/csv")
        assert status == 200
        got = [float(s) for s in out.strip().splitlines()[1:]]
        assert got == [float(s) for s in _score(fleet_dirs["tenant-b"][1], data[:3])]

    def test_bad_body_is_a_400(self, served_fleet):
        status, body = _post(served_fleet.url, "/score/tenant-a", b"{not json")
        assert status == 400 and json.loads(body)["status"] == 400

    def test_models_listing_and_healthz_sections(self, served_fleet, data):
        _post(served_fleet.url, "/score/tenant-a", {"row": [float(v) for v in data[0]]})
        doc = _get(served_fleet.url, "/models")
        assert doc["resident_models"] == 1 and doc["autopilot_rung"] is None
        rows = {r["model_id"]: r for r in doc["models"]}
        assert rows["tenant-a"]["resident"] is True
        assert rows["tenant-a"]["generation"] == 1
        assert rows["tenant-b"]["resident"] is False
        hz = _get(served_fleet.url, "/healthz")
        assert hz["serving"]["fleet"] is True
        tenants = hz["serving"]["tenants"]
        assert tenants["tenant-a"]["resident"] is True
        assert tenants["tenant-a"]["retrain_in_progress"] is False
        assert tenants["tenant-b"]["resident"] is False

    def test_reload_route(self, served_fleet, data):
        status, body = _post(served_fleet.url, "/reload/tenant-b", b"")
        assert status == 200
        assert json.loads(body) == {"generation": None, "lifecycle": True, "model_id": "tenant-b",
                                    "reloaded": False, "resident": False}
        _post(served_fleet.url, "/score/tenant-a", {"row": [float(v) for v in data[0]]})
        status, body = _post(served_fleet.url, "/reload/tenant-a", b"")
        assert status == 200 and json.loads(body)["resident"] is True and json.loads(body)["generation"] == 1
        status, body = _post(served_fleet.url, "/reload/ghost", b"")
        assert status == 404 and json.loads(body)["models"] == ["tenant-a", "tenant-b"]

    def test_per_tenant_series_labelled_in_snapshot(self, served_fleet, data):
        _post(served_fleet.url, "/score/tenant-a", {"row": [float(v) for v in data[0]]})
        doc = _get(served_fleet.url, "/snapshot")
        for name in ("isoforest_fleet_request_seconds", "isoforest_fleet_responses_total",
                     "isoforest_fleet_generation"):
            assert any(s["labels"].get("model_id") == "tenant-a" for s in doc["metrics"][name]["series"]), name

    def test_prefix_routing_and_json_404(self):
        server = MetricsServer(port=0).start()
        try:
            server.register_post_prefix("/echo/", lambda suffix, body, headers, query="": (
                200, "application/json", json.dumps({"suffix": suffix, "bytes": len(body)}) + "\n"))
            status, body = _post(server.url, "/echo/some-id", {"x": 1})
            assert status == 200 and json.loads(body)["suffix"] == "some-id"
            status, body = _post(server.url, "/echo/", {"x": 1})
            assert status == 404 and json.loads(body)["status"] == 404
            status, body = _post(server.url, "/nope", {"x": 1})
            doc = json.loads(body)
            assert status == 404 and "/echo/<suffix>" in doc["routes"]
            server.register_post("/echo/exact", lambda body, headers, query="": (200, "text/plain", "exact"))
            assert _post(server.url, "/echo/exact", {"x": 1}) == (200, "exact")
            server.unregister_post_prefix("/echo/")
            assert _post(server.url, "/echo/some-id", {"x": 1})[0] == 404
        finally:
            server.stop()


class TestCrossTenantIsolation:
    def test_stalled_swap_and_saturated_queue_on_a_leave_b_exact(self, fleet_dirs, tmp_path, data):
        swap_entered, swap_release = threading.Event(), threading.Event()

        def slow_swap():
            swap_entered.set()
            assert swap_release.wait(timeout=300)

        fc = faults.FakeClock()
        registry = ModelRegistry(config=_fast_config(), device="cpu")
        registry.register("tenant-a", fleet_dirs["tenant-a"][0], work_dir=str(tmp_path / "wd-a"),
                          config=_fast_config(batch_rows=64, max_queue_rows=64), manager_kwargs={
                              "auto_retrain": False, "background": True, "checkpoint_every": 4, "clock": fc.now,
                              "sleep": fc.sleep, "hooks": {"mid_swap": slow_swap}})
        registry.register("tenant-b", fleet_dirs["tenant-b"][0], work_dir=str(tmp_path / "wd-b"))
        server = MetricsServer(port=0).start()
        mount_fleet(server, FleetService(registry))
        model_b = fleet_dirs["tenant-b"][1]
        try:
            registry.score("tenant-a", data[:16])
            entry_a = registry.entry("tenant-a")
            for i in range(4):
                entry_a.manager.score(data[i * 512 : (i + 1) * 512])
            assert entry_a.manager.retrain(reason="chaos", wait=False)
            assert swap_entered.wait(timeout=300)
            rows = np.resize(data, (65, data.shape[1]))
            status, body = _post(server.url, "/score/tenant-a", {"rows": [[float(v) for v in r] for r in rows]})
            assert status == 429, body
            # B concurrently, one row a request: every answer 200 and its
            # row's model.score (one row a flush on the CPU too)
            results, errors = [None] * 8, []
            go = threading.Barrier(8)

            def worker(i):
                try:
                    go.wait(timeout=120)
                    status, body = _post(server.url, "/score/tenant-b", {"row": [float(v) for v in data[i]]})
                    assert status == 200, body
                    results[i] = json.loads(body)["scores"][0]
                except Exception as exc:  # surfaced below
                    errors.append(exc)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            # a flush may coalesce rows: each flush equals model.score of its
            # rows, and a row alone within 1 ulp of it on the CPU
            np.testing.assert_allclose(results, [float(s) for s in _score(model_b, data[:8])], rtol=2.5e-7, atol=0)
            swap_release.set()
            assert entry_a.manager.wait_retrain(timeout_s=300)
            assert entry_a.manager.generation == 2
            assert registry.entry("tenant-b").generation == 1
            status, body = _post(server.url, "/score/tenant-b", {"rows": [[float(v) for v in r] for r in data[:8]]})
            assert status == 200
            assert json.loads(body)["scores"] == [float(s) for s in _score(model_b, data[:8])]
            status, body = _post(server.url, "/score/tenant-a", {"rows": [[float(v) for v in r] for r in data[:8]]})
            assert status == 200 and json.loads(body)["generation"] == 2
        finally:
            swap_release.set()
            server.stop()
            registry.close()


class TestServeFleetAssembly:
    def test_discovery_skips_non_model_dirs(self, fleet_dirs, tmp_path):
        root = tmp_path / "models"
        root.mkdir()
        for t in TENANTS[:2]:
            shutil.copytree(fleet_dirs[t][0], str(root / t))
        (root / "tenant-a.lifecycle").mkdir()
        (root / "notes").mkdir()
        assert sorted(discover_models(str(root))) == ["tenant-a", "tenant-b"]

    def test_serve_fleet_requires_exactly_one_source(self, tmp_path):
        with pytest.raises(ValueError, match="exactly one"):
            serve_fleet()
        with pytest.raises(ValueError, match="no sealed model"):
            serve_fleet(str(tmp_path))

    def test_weights_and_preload(self, fleet_dirs, tmp_path):
        handle = serve_fleet(models={t: fleet_dirs[t][0] for t in TENANTS[:2]}, config=_fast_config(),
                             work_root=str(tmp_path / "w"), weights={"tenant-b": 0.25}, preload=True, device="cpu")
        try:
            state = {r["model_id"]: r for r in handle.registry.models_state()}
            assert state["tenant-a"]["resident"] and state["tenant-b"]["resident"]
            assert (state["tenant-a"]["weight"], state["tenant-b"]["weight"]) == (1.0, 0.25)
            assert len(telemetry.get_events(kind="fleet.start")) == 1
        finally:
            handle.close()


# -- parity with the JAX package ----------------------------------------------

SEQUENCE = ("tenant-a", "tenant-b", "tenant-a", "tenant-c", "tenant-b", "tenant-a", "tenant-c")


def _fleet_trace(registry_cls, config_cls, tel, models, data, work, **kw):
    """One request sequence over a budgeted three-tenant registry; returns
    the residency events, the final state and each request's scores."""
    registry = registry_cls(config=config_cls(linger_ms=0.0, request_timeout_s=120.0), **kw)
    for model_id in TENANTS:
        registry.register(model_id, models[model_id], work_dir=str(work / model_id))
    try:
        scores = [np.asarray(registry.score(t, data[i * 64 : (i + 1) * 64]), np.float64)
                  for i, t in enumerate(SEQUENCE)]
        registry.evict("tenant-c")
        rows = [{k: r[k] for k in ("model_id", "resident", "resident_bytes", "loads", "last_used_seq", "generation")}
                for r in registry.models_state()]
        state = registry.state()
    finally:
        registry.close()
    keep = ("model_id", "cause", "bytes", "resident_models", "resident_bytes")
    events = [(e.kind, {k: e.fields[k] for k in keep if k in e.fields}) for e in tel.get_events()
              if e.kind in ("fleet.load", "fleet.evict")]
    return events, rows, state, scores


def test_the_same_requests_load_and_evict_as_the_jax_package(data, tmp_path):
    """Both packages over the same three saved tenants (the JAX package's
    fits), a budget for two of them and the same request sequence: the
    same loads and evictions in the same order with the same bytes, the
    same tenant rows and totals; scores within 2e-6."""
    from isoforest_tpu import IsolationForest as JaxForest
    from isoforest_tpu import telemetry as jax_telemetry
    from isoforest_tpu.fleet import ModelRegistry as JaxRegistry
    from isoforest_tpu.fleet import layout_nbytes as jax_layout_nbytes
    from isoforest_tpu.serving import ServingConfig as JaxConfig

    models = {}
    for i, model_id in enumerate(TENANTS):
        path = str(tmp_path / "models" / model_id)
        jax_model = JaxForest(num_estimators=N_TREES, max_samples=64.0, random_seed=i + 1).fit(data)
        jax_model.save(path)
        models[model_id] = path
    one = jax_layout_nbytes(jax_model)
    assert layout_nbytes(load_model(models["tenant-c"], device="cpu")) == one
    budget = int(one * 2.5)
    jax_telemetry.reset()
    try:
        want = _fleet_trace(JaxRegistry, JaxConfig, jax_telemetry, models, data, tmp_path / "jax",
                            budget_bytes=budget)
    finally:
        jax_telemetry.reset()
    got = _fleet_trace(ModelRegistry, ServingConfig, telemetry, models, data, tmp_path / "port",
                       budget_bytes=budget, device="cpu")
    assert got[0] == want[0]
    assert [e for e in got[0] if e[0] == "fleet.evict"][:3] == [
        ("fleet.evict", {"model_id": m, "cause": "budget", "bytes": one, "resident_models": 2,
                         "resident_bytes": 2 * one}) for m in ("tenant-b", "tenant-a", "tenant-c")]
    assert got[1] == want[1]
    assert got[2] == want[2]
    for mine, theirs in zip(got[3], want[3]):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=2e-6)
