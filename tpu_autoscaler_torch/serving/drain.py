"""Typed drain receipt: the serve.py scale-in handoff contract.

The drain contract (docs/SERVING.md): scale-in never reclaims a
serving replica's slice out from under it — the platform stops
admission, the replica finishes its queue, and its LAST stdout line is
one machine-readable ``final_stats`` JSON object.  Three consumers
read that object — serve.py emitting it, the reclaim tests asserting
``unserved == 0``, and the scaler's scale-in advice documenting it — so
as an untyped dict a renamed field would drift silently.
:class:`DrainReceipt` is the one definition:

- ``serve.py`` *builds* its final-stats payload through it;
- the router (serving/router.py ``absorb_drain``) *consumes* it to
  migrate the unserved remainder — the no-lost-requests half of the
  chaos ``router`` invariant;
- the scaler (``ServingScaler.confirm_scale_in``) *consumes* it to
  retire the drained replica from the adapter census and account
  clean vs dirty drains.

``from_payload`` validates structurally (event tag, types, counts,
aligned per-request arrays) and raises ``ValueError`` with the field
name on any mismatch — a malformed receipt fails loudly at the
boundary, never as a KeyError three layers deeper.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

#: The payload's event tag — the discriminator consumers match on
#: when scanning mixed stdout lines.
EVENT = "final_stats"


@dataclasses.dataclass(frozen=True)
class DrainReceipt:
    """One replica's end-of-life accounting (see module docstring).

    ``request_*_ticks`` are aligned per submitted request; ``None``
    entries are requests that never reached that milestone (an
    unserved request has no latency).  ``replica`` is the emitting
    replica's id — empty when the server wasn't told one (standalone
    CLI runs), required by the router migration path.
    """

    served: int
    unserved: int
    drained: bool
    elapsed_s: float
    ticks: int
    decode_tokens: int
    request_latency_ticks: tuple[float | None, ...]
    request_wait_ticks: tuple[float | None, ...]
    request_exec_ticks: tuple[float | None, ...]
    stats: Mapping[str, Any]
    replica: str = ""

    @property
    def clean(self) -> bool:
        """A clean drain served everything it admitted."""
        return self.drained and self.unserved == 0

    def to_payload(self) -> dict[str, Any]:
        """The wire dict — exactly the historical final-stats key set
        (older consumers keep working) plus ``replica``."""
        return {
            "event": EVENT,
            "served": self.served,
            "unserved": self.unserved,
            "drained": self.drained,
            "elapsed_s": self.elapsed_s,
            "ticks": self.ticks,
            "decode_tokens": self.decode_tokens,
            "request_latency_ticks": list(self.request_latency_ticks),
            "request_wait_ticks": list(self.request_wait_ticks),
            "request_exec_ticks": list(self.request_exec_ticks),
            "stats": dict(self.stats),
            "replica": self.replica,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_payload())

    @classmethod
    def from_payload(cls, payload: Mapping[str, Any]) -> "DrainReceipt":
        """Parse + validate one receipt dict; ValueError names the
        offending field."""
        if not isinstance(payload, Mapping):
            raise ValueError("drain receipt: payload is not a mapping")
        if payload.get("event") != EVENT:
            raise ValueError(
                f"drain receipt: event != {EVENT!r} "
                f"(got {payload.get('event')!r})")

        def _int(key: str) -> int:
            v = payload.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(
                    f"drain receipt: {key} must be a non-negative "
                    f"int (got {v!r})")
            return v

        def _ticks(key: str) -> tuple[float | None, ...]:
            v = payload.get(key)
            if not isinstance(v, (list, tuple)):
                raise ValueError(
                    f"drain receipt: {key} must be a list")
            out: list[float | None] = []
            for x in v:
                if x is None:
                    out.append(None)
                elif isinstance(x, (int, float)) \
                        and not isinstance(x, bool):
                    out.append(float(x))
                else:
                    raise ValueError(
                        f"drain receipt: {key} entries must be "
                        f"numbers or null (got {x!r})")
            return tuple(out)

        served = _int("served")
        unserved = _int("unserved")
        drained = payload.get("drained")
        if not isinstance(drained, bool):
            raise ValueError("drain receipt: drained must be a bool")
        elapsed = payload.get("elapsed_s")
        if not isinstance(elapsed, (int, float)) \
                or isinstance(elapsed, bool) or elapsed < 0:
            raise ValueError(
                "drain receipt: elapsed_s must be a non-negative "
                "number")
        lat = _ticks("request_latency_ticks")
        wait = _ticks("request_wait_ticks")
        exe = _ticks("request_exec_ticks")
        if not (len(lat) == len(wait) == len(exe)):
            raise ValueError(
                "drain receipt: request_*_ticks arrays are not "
                f"aligned ({len(lat)}/{len(wait)}/{len(exe)})")
        # Aggregate-only receipts (empty per-request arrays) are
        # legal — queueing-model replicas account cohorts, not
        # requests; when the arrays ARE present they must cover
        # every submitted request.
        if lat and served + unserved != len(lat):
            raise ValueError(
                "drain receipt: served + unserved != request count "
                f"({served} + {unserved} != {len(lat)})")
        stats = payload.get("stats")
        if not isinstance(stats, Mapping):
            raise ValueError("drain receipt: stats must be a mapping")
        replica = payload.get("replica", "")
        if not isinstance(replica, str):
            raise ValueError("drain receipt: replica must be a string")
        return cls(served=served, unserved=unserved, drained=drained,
                   elapsed_s=float(elapsed), ticks=_int("ticks"),
                   decode_tokens=_int("decode_tokens"),
                   request_latency_ticks=lat, request_wait_ticks=wait,
                   request_exec_ticks=exe, stats=dict(stats),
                   replica=replica)

    @classmethod
    def parse_line(cls, line: str) -> "DrainReceipt":
        """Parse one stdout line (the server's last line)."""
        try:
            payload = json.loads(line)
        except json.JSONDecodeError as exc:
            raise ValueError(
                f"drain receipt: line is not JSON ({exc})") from exc
        return cls.from_payload(payload)
