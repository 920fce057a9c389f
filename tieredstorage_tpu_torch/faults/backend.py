"""FaultInjectingBackend: a StorageBackend decorator executing a FaultSchedule.

Transparent when the schedule is empty; otherwise each upload/fetch/delete is
counted against the schedule and any fired rule either fails the call
(`raise`, `key-not-found`), slows it (`delay`), or mutates fetched bytes
(`truncate`, `corrupt`). `delete_all` is inherited from ObjectDeleter's
per-key loop so multi-deletes see per-key faults too.

Two entry points:
- wrap programmatically: ``FaultInjectingBackend(delegate, schedule)`` —
  what the tests do;
- configure reflectively as ``storage.backend.class`` with
  ``fault.delegate.class`` + ``fault.schedule`` (+ ``fault.seed``); every
  non-``fault.*`` key is passed through to the delegate — what soak stacks
  do. The RSM-level ``fault.injection.enabled`` flag wraps the configured
  backend the same way without touching storage configs.
"""

from __future__ import annotations

import io
import time
from typing import BinaryIO, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import ConfigDef, ConfigKey
from tieredstorage_tpu_torch.faults.schedule import (
    DATA_ACTIONS,
    FaultInjectedException,
    FaultRule,
    FaultSchedule,
)
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    load_backend_class,
)


def _definition() -> ConfigDef:
    d = ConfigDef()
    d.define(ConfigKey(
        "fault.delegate.class", "string", default=None, importance="low",
        doc="Backend class to wrap when FaultInjectingBackend is configured "
            "as storage.backend.class.",
    ))
    d.define(ConfigKey(
        "fault.schedule", "list", default=[], importance="low",
        doc="Fault rules 'op:action[=arg][@trigger]' (see faults/schedule.py).",
    ))
    d.define(ConfigKey(
        "fault.seed", "long", default=0, importance="low",
        doc="Seed for probabilistic fault triggers.",
    ))
    return d


class FaultInjectingBackend(StorageBackend):
    def __init__(
        self,
        delegate: Optional[StorageBackend] = None,
        schedule: Optional[FaultSchedule] = None,
    ) -> None:
        self._delegate = delegate
        self._schedule = schedule if schedule is not None else FaultSchedule([])

    @property
    def delegate(self) -> StorageBackend:
        return self._delegate

    @property
    def schedule(self) -> FaultSchedule:
        return self._schedule

    def configure(self, configs: Mapping[str, object]) -> None:
        values = _definition().parse(configs)
        if values["fault.schedule"]:
            self._schedule = FaultSchedule.parse(
                values["fault.schedule"], seed=values["fault.seed"]
            )
        if self._delegate is None:
            class_path = values["fault.delegate.class"]
            if class_path is None:
                raise ValueError(
                    "fault.delegate.class must be provided when "
                    "FaultInjectingBackend is constructed without a delegate"
                )
            self._delegate = load_backend_class(str(class_path))()
        passthrough = {
            k: v for k, v in configs.items() if not str(k).startswith("fault.")
        }
        self._delegate.configure(passthrough)

    # ------------------------------------------------------------- injection
    def _apply(self, op: str, key: ObjectKey) -> list[FaultRule]:
        """Execute fail/delay rules; return data-mutation rules for fetch."""
        data_rules: list[FaultRule] = []
        for rule in self._schedule.fired_rules(op, key):
            if rule.action == "delay":
                # Fixed arg, or a seeded uniform draw for `delay=lo..hi`.
                time.sleep(self._schedule.delay_ms(rule) / 1000.0)
            elif rule.action == "raise":
                raise FaultInjectedException(
                    f"Injected {op} fault for {key} "
                    f"(call #{self._schedule.calls(op)})"
                )
            elif rule.action == "key-not-found":
                raise KeyNotFoundException(self, key)
            elif rule.action in DATA_ACTIONS:
                data_rules.append(rule)
        return data_rules

    @staticmethod
    def _mutate(data: bytes, rules: list[FaultRule]) -> bytes:
        for rule in rules:
            if not data:
                continue
            if rule.action == "truncate":
                keep = rule.arg if rule.arg is not None else len(data) // 2
                data = data[:keep]
            elif rule.action == "corrupt":
                pos = (rule.arg if rule.arg is not None else 0) % len(data)
                data = data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]
        return data

    # ------------------------------------------------------------- contract
    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        self._apply("upload", key)
        return self._delegate.upload(input_stream, key)

    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        data_rules = self._apply("fetch", key)
        stream = self._delegate.fetch(key, byte_range)
        if not data_rules:
            return stream
        with stream:
            data = stream.read()
        return io.BytesIO(self._mutate(data, data_rules))

    def delete(self, key: ObjectKey) -> None:
        self._apply("delete", key)
        self._delegate.delete(key)

    def list_objects(self, prefix: str = ""):
        # Listing faults fail/slow the whole enumeration; data actions are
        # fetch-only and cannot fire here (schedule-level validation).
        self._apply("list", ObjectKey(prefix))
        return self._delegate.list_objects(prefix)

    def __str__(self) -> str:
        return f"FaultInjectingBackend{{delegate={self._delegate}}}"
