"""The reader of `stage_kernel.share`: the port's stage-kernel counters as
a share, and nothing where the port has no such counters."""
from bench_h100.spec import HERE, load_module
from halide_tpu_torch import spans


def _read(rec=None):
    return load_module(HERE / "metrics" / "stage_kernel.share.py").read(
        rec or {})


def _counters(monkeypatch, **kw):
    base = {"plan_cache.hits": 3, "plan_cache.misses": 1}
    base.update({k.replace("__", "."): v for k, v in kw.items()})
    monkeypatch.setattr(spans, "counters", lambda: base)


def test_share_is_fused_over_fused_and_declined(monkeypatch):
    _counters(monkeypatch, stage_kernel__fused=38,
              stage_kernel__declined=2)
    assert _read() == 95.0


def test_none_on_a_port_without_the_counters(monkeypatch):
    _counters(monkeypatch)
    assert _read() is None


def test_none_where_no_stage_ran(monkeypatch):
    _counters(monkeypatch, stage_kernel__fused=0, stage_kernel__declined=0)
    assert _read() is None
