"""The port's link-cost model (``dlrover_tpu_torch/parallel/topology.py``)
against the JAX package's, on the CPU: the JSON format read by either
package, the derived knobs (``bucket_bytes_for``, ``alltoall_time_s``,
``slice_throughput_weights``, ``price_host_transfer``) and the observed
rail-rate EWMA from the same inputs, compared exactly (the same float
expressions), and the probe cache keyed by the device fingerprint in a
tmp dir (``DLROVER_TPU_TOPOLOGY_CACHE``)."""

import json

import pytest

from dlrover_tpu.parallel import topology as jtop
from dlrover_tpu_torch.parallel import topology as ttop

MODELS = [
    # every field given: the two packages' defaults are their own
    # platforms' fallbacks
    dict(ici_gbps=90.0, dcn_gbps=12.5, host_d2h_gbps=8.0, host_h2d_gbps=8.0, ici_lat_s=1e-6,
         dcn_lat_s=5e-5, host_lat_s=1e-5),
    dict(ici_gbps=300.0, dcn_gbps=25.0, host_d2h_gbps=20.0, host_h2d_gbps=24.0, ici_lat_s=3e-6,
         dcn_lat_s=4e-5, host_lat_s=8e-6, ici_axis_gbps=(("dp", 300.0), ("fsdp", 150.0)),
         source="measured", fingerprint="abc", probed_at=12.5),
]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path))
    jtop.reset_link_model()
    ttop.reset_link_model()
    yield
    jtop.reset_link_model()
    ttop.reset_link_model()


@pytest.mark.parametrize("kw", MODELS)
def test_json_reads_back_in_either_package(kw):
    j, t = jtop.LinkModel(**kw), ttop.LinkModel(**kw)
    assert t.to_json() == j.to_json()
    assert ttop.LinkModel.from_json(j.to_json()).to_json() == j.to_json()
    assert jtop.LinkModel.from_json(t.to_json()).to_json() == t.to_json()
    assert sorted(json.loads(t.to_json())) == sorted(json.loads(j.to_json()))
    for h2d in (False, True):
        assert t.sec_per_host_byte(h2d) == j.sec_per_host_byte(h2d)
    for axis in ("dp", "fsdp", "tp"):
        assert t.sec_per_axis_byte(axis) == j.sec_per_axis_byte(axis)
    assert (t.sec_per_ici_byte(), t.sec_per_dcn_byte(), t.ordering_ok) == (
        j.sec_per_ici_byte(), j.sec_per_dcn_byte(), j.ordering_ok)


def test_the_fallback_is_the_h100_platform_spec_and_flagged_unprobed():
    """No TPU figure carries over: the fallback rates are NVLink 4,
    InfiniBand NDR and PCIe Gen5 x16 (per direction), and a model made of
    them, or with unprobed links between cards, is flagged when priced."""
    assert (ttop.FALLBACK_ICI_GBPS, ttop.FALLBACK_DCN_GBPS, ttop.FALLBACK_HOST_GBPS) == (450.0, 50.0, 64.0)
    assert ttop.FALLBACK_ICI_GBPS != jtop.FALLBACK_ICI_GBPS
    assert ttop.FALLBACK_DCN_GBPS != jtop.FALLBACK_DCN_GBPS
    m = ttop.probe_link_model(devices="cpu", measure_on_cpu=True, probe_mb=1, force=True)
    # one rank: no link between cards to time, the host legs measured
    assert m.source == "measured-host" and m.ici_axis_gbps == ()
    assert (m.ici_gbps, m.dcn_gbps) == (ttop.FALLBACK_ICI_GBPS, ttop.FALLBACK_DCN_GBPS)
    assert m.host_d2h_gbps > 0 and m.host_h2d_gbps > 0
    ttop.note_fallback_use(m)
    assert ttop._FALLBACK_WARNED


@pytest.mark.parametrize("kw", MODELS)
def test_derived_knobs_match(kw):
    j, t = jtop.LinkModel(**kw), ttop.LinkModel(**kw)
    for link in ("ici", "dcn", "host"):
        for ms in (0.01, 2.0, 50.0, 1e4):
            assert ttop.bucket_bytes_for(t, link, ms) == jtop.bucket_bytes_for(j, link, ms)
    with pytest.raises(ValueError):
        ttop.bucket_bytes_for(t, "nvlink")
    for nbytes, n, dcn in ((1 << 20, 4, False), (1 << 26, 8, True), (0, 4, False), (123, 1, True)):
        assert ttop.alltoall_time_s(nbytes, n, t, dcn) == jtop.alltoall_time_s(nbytes, n, j, dcn)
    for nbytes, h2d in ((1 << 20, False), (7, True), (0, True)):
        assert ttop.price_host_transfer(nbytes, h2d, t) == jtop.price_host_transfer(nbytes, h2d, j)
    for d in ("d2h", "h2d", "peer"):
        assert ttop.rail_link_gbps(t, d) == jtop.rail_link_gbps(j, d)


@pytest.mark.parametrize("times", [[], [1.0], [1.0, 2.0, 4.0], [0.5, 0.0, -1.0, 2.0], [0.0, 0.0]])
def test_slice_throughput_weights_match(times):
    assert ttop.slice_throughput_weights(times) == jtop.slice_throughput_weights(times)


def test_rail_rate_ewma_matches(tmp_path):
    samples = [("d2h", 20.0), ("d2h", 10.0), ("h2d", 30.0), ("peer", 5.0), ("d2h", 40.0),
               ("bogus", 9.0), ("h2d", 0.0), ("h2d", 27.5)]
    jd, td = tmp_path / "j", tmp_path / "t"
    for rail, gbps in samples:
        jr = jtop.observe_rail_rate(rail, gbps, dir_override=str(jd))
        tr = ttop.observe_rail_rate(rail, gbps, dir_override=str(td))
        assert (tr.gbps, tr.samples) == (jr.gbps, jr.samples)
    base_j, base_t = jtop.LinkModel(**MODELS[1]), ttop.LinkModel(**MODELS[1])
    assert ttop.apply_observed_rates(base_t, tr).to_json() == jtop.apply_observed_rates(base_j, jr).to_json()
    # persisted beside the probe cache, per fingerprint
    back = ttop.load_rail_rates(tr.fingerprint, str(td))
    assert back is not None and back.gbps == tr.gbps
    # the overlay reaches every pricing query
    ttop.set_link_model(base_t)
    assert ttop.get_link_model().host_d2h_gbps == tr.gbps["d2h"]


def test_probe_cache_is_keyed_by_fingerprint(tmp_path, monkeypatch):
    """The probe persists per fingerprint: a second probe of the same
    world reads the cache without measuring, a different world (another
    node count) misses it, and a file copied across worlds is refused."""
    d = str(tmp_path / "cache")
    first = ttop.probe_link_model(devices="cpu", cache_dir=d, measure_on_cpu=True, probe_mb=1)
    fp = ttop.device_fingerprint("cpu")
    assert first.fingerprint == fp and (tmp_path / "cache" / f"linkmodel-{fp}.json").exists()

    def no_probe(*a, **k):
        raise AssertionError("a cached world must not be probed")

    monkeypatch.setattr(ttop, "_time_host_link", no_probe)
    again = ttop.probe_link_model(devices="cpu", cache_dir=d, measure_on_cpu=True, probe_mb=1)
    assert again.to_json() == first.to_json()
    monkeypatch.setenv("DLROVER_TPU_NODE_NUM", "2")
    other = ttop.device_fingerprint("cpu")
    assert other != fp and ttop.load_cached(other, d) is None
    # a file of another world under this world's name is stale
    (tmp_path / "cache" / f"linkmodel-{other}.json").write_text(first.to_json())
    assert ttop.load_cached(other, d) is None
    # the CPU without measure_on_cpu: the fallback, cached and current
    cpu = ttop.probe_link_model(devices="cpu", cache_dir=d)
    assert cpu.source == "fallback-cpu" and ttop.get_link_model(cache_dir=d).to_json() == cpu.to_json()


def test_the_default_cache_dir_honours_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_TOPOLOGY_CACHE", str(tmp_path / "x"))
    assert ttop.cache_dir() == jtop.cache_dir() == str(tmp_path / "x")
    assert ttop.cache_path("f") == jtop.cache_path("f")
