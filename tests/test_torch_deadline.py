"""The port's end-to-end deadline (tieredstorage_tpu_torch/utils/deadline.py)
against the JAX package's, on one frozen monotonic clock.

Each package's module reads `time.monotonic`; the tests swap the module's
`time` for a fake whose clock stands still, so a wire value, a remaining
budget and an error message come out exactly equal in both packages. The
wire grammar is held on the malformed values of the JAX suite; the entry
helper `ensure_deadline` prefers the caller's deadline over the default.
"""

from __future__ import annotations

import types

import pytest

from tieredstorage_tpu.utils import deadline as jax_deadline
from tieredstorage_tpu_torch.utils import deadline as port_deadline

MODULES = {"jax": jax_deadline, "port": port_deadline}
NOW = 1000.0

MALFORMED = [None, "", "  ", "abc", "-5", "+5", "1_0", "٥٠", "1.5", "5 0", "0x10"]
WELL_FORMED = ["0", "1", "5000", " 42 ", "007", "86400000"]


@pytest.fixture
def frozen(monkeypatch):
    """Both modules on one clock that stands at NOW until moved."""
    clock = [NOW]
    fake = types.SimpleNamespace(monotonic=lambda: clock[0])
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "time", fake)
    return clock


@pytest.mark.parametrize("value", MALFORMED + WELL_FORMED)
def test_parse_deadline_ms_equals_jax(frozen, value):
    parsed = {k: mod.parse_deadline_ms(value) for k, mod in MODULES.items()}
    if parsed["jax"] is None:
        assert parsed["port"] is None
        return
    assert parsed["port"].at_monotonic == parsed["jax"].at_monotonic
    assert parsed["port"].expired == parsed["jax"].expired
    # Round trip: the wire form is the value it came from, or one more when
    # the float budget lands a hair above the whole millisecond (ceil).
    assert parsed["port"].header_value() == parsed["jax"].header_value()
    assert int(parsed["port"].header_value()) - int(value) in (0, 1)


@pytest.mark.parametrize("remaining_s", [-3.0, -0.0004, 0.0, 0.0004, 0.0015, 1.0, 5.0, 123.4567])
def test_header_value_equals_jax(frozen, remaining_s):
    values = {k: mod.Deadline(NOW + remaining_s).header_value() for k, mod in MODULES.items()}
    assert values["port"] == values["jax"]
    assert int(values["port"]) >= 0


def test_after_ms_and_expiry_equal_jax(frozen):
    for ms in (0, 1, 250, 5000):
        port, jax = (mod.Deadline.after_ms(ms) for mod in MODULES.values())
        assert port.at_monotonic == jax.at_monotonic == NOW + ms / 1000.0
        assert port.expired == jax.expired == (ms == 0)
    frozen[0] += 0.3
    assert port_deadline.Deadline.after_ms(250).remaining_s() == pytest.approx(0.25)
    assert port_deadline.DEADLINE_HEADER == jax_deadline.DEADLINE_HEADER == "x-deadline-ms"


@pytest.mark.parametrize("package", sorted(MODULES))
def test_ensure_deadline_prefers_the_callers(frozen, package):
    mod = MODULES[package]
    caller = mod.Deadline.after(5.0)
    with mod.deadline_scope(caller), mod.ensure_deadline(60.0) as effective:
        assert effective is caller
    with mod.ensure_deadline(60.0) as effective:
        assert effective.at_monotonic == NOW + 60.0
        assert mod.current_deadline() is effective
    assert mod.current_deadline() is None
    with mod.ensure_deadline(None) as effective:
        assert effective is None


def test_ensure_deadline_outcomes_equal_jax(frozen):
    """The same nesting of caller scopes and defaults gives the same
    effective deadline in both packages."""
    cases = [(None, None), (None, 2.0), (5.0, None), (5.0, 60.0), (60.0, 5.0), (-1.0, 60.0)]
    for caller_s, default_s in cases:
        got = {}
        for k, mod in MODULES.items():
            caller = None if caller_s is None else mod.Deadline.after(caller_s)
            with mod.deadline_scope(caller), mod.ensure_deadline(default_s) as effective:
                got[k] = None if effective is None else effective.at_monotonic
        assert got["port"] == got["jax"], (caller_s, default_s)


def test_check_deadline_messages_and_counters_equal_jax(frozen):
    messages = {}
    for k, mod in MODULES.items():
        before = mod.exceeded_total()
        mod.check_deadline("unconstrained")
        with mod.deadline_scope(mod.Deadline.after(10.0)):
            mod.check_deadline("plenty of budget")
        with mod.deadline_scope(mod.Deadline.after(-0.25)):
            with pytest.raises(mod.DeadlineExceededException) as err:
                mod.check_deadline("chunk fetch of k")
        messages[k] = str(err.value)
        # Each package's counter moves by its own raise only.
        assert mod.exceeded_total() == before + 1
    assert messages["port"] == messages["jax"]
    assert "over budget by 250 ms" in messages["port"]


def test_scope_nesting_tightens_only():
    d = port_deadline
    outer, loose, tight = d.Deadline.after(10.0), d.Deadline.after(100.0), d.Deadline.after(1.0)
    with d.deadline_scope(outer):
        with d.deadline_scope(loose):
            assert d.current_deadline() is outer
        with d.deadline_scope(tight):
            assert d.current_deadline() is tight
        with d.deadline_scope(None):
            assert d.current_deadline() is outer
    assert d.current_deadline() is None
