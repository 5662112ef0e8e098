"""Seeded fault injection for the elastic control plane (counterpart of
``dt_tpu/elastic/faults.py``, copied since the port imports nothing of the
JAX package; the same plan and seed make the same decisions in both).

Kinds: ``drop``, ``dup``, ``delay``, ``reorder``, ``reset`` and
``partition`` act on transport traffic (``protocol.request`` on the send
side, the scheduler on the receive side); ``crash``, ``nan``, ``stall``
and site-scoped ``delay`` rules fire at named hooks (:func:`crash_point`,
:func:`nan_point`, :func:`stall_point`, :func:`delay_point`).  A crash
rule either raises :class:`CrashInjected` or, with ``action="exit"``,
ends the process with ``os._exit(137)``, as a SIGKILL would.

Crash sites, under the JAX package's names so that one seeded plan means
the same in both: ``client.register``, ``client.heartbeat``,
``client.mc_barrier``; ``sched.register``, ``sched.barrier_arrived``,
``sched.allreduce``, ``sched.membership_change``; the fleet checkpoint's
``sched.ckpt_intent``, ``sched.ckpt_ack`` and ``sched.ckpt_commit`` (every
ack journaled, the commit not: the torn window), ``worker.ckpt_save``
(after the intent, before the save) and ``worker.resume`` (a worker dying
while it restores); ``module.epoch_begin``.

Every probabilistic rule draws from a stream seeded by ``(seed, rule
index, host)`` (crc32, so ``PYTHONHASHSEED`` does not matter): one host's
draws never interleave with another's.  In process: ``install(FaultPlan(
[...], seed=0))`` / ``clear()``; in subprocess workers: ``DT_FAULT_PLAN``
(the plan's JSON, or ``@/path``), loaded on first use.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from dt_tpu_torch import config
from dt_tpu_torch.obs import trace as obs_trace

KINDS = ("drop", "dup", "delay", "reorder", "reset", "partition", "crash",
         "nan", "stall")


def _obs_fault(kind: str, op: str, idx: int, cmd: Optional[str] = None,
               host: Optional[str] = None, site: Optional[str] = None,
               **extra: Any) -> None:
    """Every APPLIED fault becomes a trace event (``fault.<kind>``) on the
    process tracer — the chaos harness's ``--trace`` run cross-checks
    these against ``applied_summary()`` so the fault harness and the obs
    subsystem verify each other."""
    if not obs_trace.enabled():
        return
    attrs: Dict[str, Any] = {"op": op, "rule": idx}
    if cmd is not None:
        attrs["cmd"] = cmd
    if host is not None:
        attrs["host"] = host
    if site is not None:
        attrs["site"] = site
    attrs.update(extra)
    obs_trace.tracer().event(f"fault.{kind}", attrs)
OPS = ("send", "recv")


class CrashInjected(RuntimeError):
    """An injected crash (rule ``action="raise"``).  Test code treats the
    raising thread's worker as dead — the in-process analog of the
    subprocess ``os._exit(137)``."""


class FaultRule:
    """One fault rule; see the module docstring for kind semantics.

    ``cmd``/``host`` scope the rule (string or sequence; None = any);
    ``prob`` gates each match through the rule's seeded stream;
    ``after`` lets the first N matches through untouched; ``times`` caps
    total applications per host; ``epoch`` pins ``crash`` rules to one
    ``module.epoch_begin`` epoch; ``action`` is ``raise`` or ``exit``.
    """

    def __init__(self, kind: str, op: str = "send",
                 cmd: Union[str, Sequence[str], None] = None,
                 host: Union[str, Sequence[str], None] = None,
                 site: Optional[str] = None, prob: float = 1.0,
                 times: Optional[int] = None, after: int = 0,
                 delay_s: float = 0.05, epoch: Optional[int] = None,
                 action: str = "raise"):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if op not in OPS:
            raise ValueError(f"unknown fault op {op!r}")
        if action not in ("raise", "exit"):
            raise ValueError(f"unknown crash action {action!r}")
        if kind in ("crash", "nan", "stall") and not site:
            raise ValueError(f"{kind} rules need a site=")
        if site and kind not in ("crash", "delay", "nan", "stall"):
            raise ValueError(f"site= applies to crash/delay/nan/stall "
                             f"rules, not {kind!r}")
        self.kind = kind
        self.op = op
        self.cmd = (cmd,) if isinstance(cmd, str) else \
            tuple(cmd) if cmd else None
        self.host = (host,) if isinstance(host, str) else \
            tuple(host) if host else None
        self.site = site
        self.prob = float(prob)
        self.times = times
        self.after = int(after)
        self.delay_s = float(delay_s)
        self.epoch = epoch
        self.action = action

    def matches(self, op: str, cmd: Optional[str],
                host: Optional[str]) -> bool:
        # site-scoped rules (crash, site-delay) never match transport
        # traffic — they fire at their named hook only
        if self.kind == "crash" or self.site is not None or \
                self.op != op:
            return False
        if self.cmd is not None and cmd not in self.cmd:
            return False
        if self.host is not None and host not in self.host:
            return False
        return True

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "op": self.op}
        if self.cmd is not None:
            d["cmd"] = list(self.cmd)
        if self.host is not None:
            d["host"] = list(self.host)
        if self.site is not None:
            d["site"] = self.site
        if self.prob != 1.0:
            d["prob"] = self.prob
        if self.times is not None:
            d["times"] = self.times
        if self.after:
            d["after"] = self.after
        if self.delay_s != 0.05:
            d["delay_s"] = self.delay_s
        if self.epoch is not None:
            d["epoch"] = self.epoch
        if self.action != "raise":
            d["action"] = self.action
        return d


class FaultPlan:
    """An ordered rule list + the seed its probabilistic streams derive
    from.  Thread-safe; one instance serves a whole process."""

    def __init__(self, rules: Sequence[Union[FaultRule, dict]],
                 seed: int = 0):
        self.seed = int(seed)
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule(**r)
            for r in rules]
        self._lock = threading.Lock()
        self._matched: Dict[Tuple[int, str], int] = {}
        self._applied: Dict[Tuple[int, str], int] = {}
        self._rngs: Dict[Tuple[int, str], random.Random] = {}
        # reorder: rule index -> the Event the parked first message waits on
        self._reorder: Dict[int, Optional[threading.Event]] = {}

    # -- deterministic per-(rule, host) streams ---------------------------

    def _stream(self, idx: int, host: str) -> random.Random:
        key = (idx, host)
        rng = self._rngs.get(key)
        if rng is None:
            # crc32, not hash(): PYTHONHASHSEED must not change the plan
            rng = random.Random(
                zlib.crc32(f"{self.seed}|{idx}|{host}".encode()))
            self._rngs[key] = rng
        return rng

    def _fire(self, idx: int, rule: FaultRule, host: Optional[str]) -> bool:
        """Count a static match; True when the rule applies this time."""
        h = host or ""
        with self._lock:
            key = (idx, h)
            n = self._matched.get(key, 0) + 1
            self._matched[key] = n
            if n <= rule.after:
                return False
            a = self._applied.get(key, 0)
            if rule.times is not None and a >= rule.times:
                return False
            if rule.prob < 1.0 and \
                    self._stream(idx, h).random() >= rule.prob:
                return False
            self._applied[key] = a + 1
            return True

    # -- transport hooks --------------------------------------------------

    def on_send(self, cmd: Optional[str],
                host: Optional[str]) -> Optional[str]:
        """Client-outbound hook (one request attempt).  Sleeps for
        delay/reorder kinds; returns ``None`` or one of
        ``"drop" | "reset" | "dup"`` for the transport to act on."""
        out = None
        for idx, r in enumerate(self.rules):
            if not r.matches("send", cmd, host) or \
                    not self._fire(idx, r, host):
                continue
            _obs_fault(r.kind, "send", idx, cmd=cmd, host=host)
            if r.kind == "delay":
                time.sleep(r.delay_s)
            elif r.kind == "reorder":
                self._reorder_gate(idx, r)
            elif r.kind in ("drop", "partition"):
                return "drop"
            elif r.kind == "reset":
                return "reset"
            elif r.kind == "dup" and out is None:
                out = "dup"
        return out

    def on_recv(self, cmd: Optional[str], host: Optional[str]) -> bool:
        """Server-inbound hook; False means drop (no response — the
        client sees a closed connection and retries)."""
        for idx, r in enumerate(self.rules):
            if not r.matches("recv", cmd, host) or \
                    not self._fire(idx, r, host):
                continue
            _obs_fault(r.kind, "recv", idx, cmd=cmd, host=host)
            if r.kind == "delay":
                time.sleep(r.delay_s)
            elif r.kind == "reorder":
                self._reorder_gate(idx, r)
            elif r.kind in ("drop", "partition", "reset"):
                return False
        return True

    def _reorder_gate(self, idx: int, rule: FaultRule) -> None:
        """First matching message parks until the next one passes (true
        overtake); ``delay_s`` caps the hold so a lone message cannot
        park forever."""
        with self._lock:
            ev = self._reorder.get(idx)
            if ev is None:
                ev = threading.Event()
                self._reorder[idx] = ev
                wait = ev
            else:
                ev.set()
                self._reorder[idx] = None
                wait = None
        if wait is not None:
            wait.wait(timeout=max(rule.delay_s, 0.05))
            with self._lock:
                if self._reorder.get(idx) is wait:
                    self._reorder[idx] = None

    # -- site hooks -------------------------------------------------------

    def delay_at(self, site: str, host: Optional[str] = None,
                 scale: float = 1.0) -> float:
        """Apply any matching site-scoped delay rules: sleep
        ``delay_s * scale`` per applied rule (``scale`` lets the call
        site tie the stall to real work, e.g. this step's batch share).
        Returns the total seconds slept (0.0 = nothing fired)."""
        slept = 0.0
        for idx, r in enumerate(self.rules):
            if r.kind != "delay" or r.site != site:
                continue
            if r.host is not None and host not in r.host:
                continue
            if not self._fire(idx, r, host):
                continue
            _obs_fault("delay", "site", idx, host=host, site=site)
            d = r.delay_s * float(scale)
            if d > 0:
                time.sleep(d)
            slept += d
        return slept

    def nan_at(self, site: str, host: Optional[str] = None,
               **ctx: Any) -> int:
        """Apply any matching site-scoped ``nan`` rules: returns how
        many fired (the call site poisons its value with that many
        non-finite entries — in practice 0 or 1).  Counted through the
        same ``_fire`` machinery as every other rule, so ``after=``
        pins the exact step and ``applied_summary()`` records it for
        the chaos cross-check."""
        fired = 0
        for idx, r in enumerate(self.rules):
            if r.kind != "nan" or r.site != site:
                continue
            if r.host is not None and host not in r.host:
                continue
            if not self._fire(idx, r, host):
                continue
            _obs_fault("nan", "site", idx, host=host, site=site,
                       **{k: v for k, v in ctx.items() if k == "step"})
            fired += 1
        return fired

    def stall_at(self, site: str, host: Optional[str] = None) -> None:
        """Apply any matching site-scoped ``stall`` rules (r16): block
        this thread INDEFINITELY — the injected hang the blackbox
        watchdog exists to catch (``chaos_run --plan hang``).  The
        stalled frame sits in THIS function, so a hang bundle's
        all-thread stacks name ``stall_at`` / the site; the process
        never resumes (the chaos harness reaps it)."""
        for idx, r in enumerate(self.rules):
            if r.kind != "stall" or r.site != site:
                continue
            if r.host is not None and host not in r.host:
                continue
            if not self._fire(idx, r, host):
                continue
            _obs_fault("stall", "site", idx, host=host, site=site)
            while True:  # deliberate: an injected hang does not end
                time.sleep(1.0)

    def crash(self, site: str, host: Optional[str] = None,
              **ctx: Any) -> None:
        for idx, r in enumerate(self.rules):
            if r.kind != "crash" or r.site != site:
                continue
            if r.host is not None and host not in r.host:
                continue
            if r.epoch is not None and ctx.get("epoch") != r.epoch:
                continue
            if not self._fire(idx, r, host):
                continue
            _obs_fault("crash", "crash", idx, host=host, site=site,
                       **{k: v for k, v in ctx.items() if k == "epoch"})
            if r.action == "exit":
                # push buffered trace records to the scheduler first (the
                # dying incarnation's timeline would otherwise vanish);
                # best-effort and obs-gated, so the exit stays
                # SIGKILL-equivalent for everything but the trace
                obs_trace.flush()
                os._exit(137)  # SIGKILL-equivalent: no cleanup, no goodbye
            raise CrashInjected(
                f"fault injection: crash at {site} (host={host}, {ctx})")

    # -- introspection / serialization ------------------------------------

    def applied_summary(self) -> List[Tuple[int, str, int]]:
        """Sorted (rule_index, host, applied_count) — the deterministic
        record tests compare across runs of the same seed."""
        with self._lock:
            return sorted((i, h, n) for (i, h), n in self._applied.items())

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_dict() for r in self.rules]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(d.get("rules", []), seed=d.get("seed", 0))


# ---------------------------------------------------------------------------
# process-global plan registry
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False
_ENV_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as this process's active plan (tests)."""
    global _PLAN, _ENV_CHECKED
    _PLAN = plan
    _ENV_CHECKED = True  # an explicit install overrides the env
    return plan


def clear() -> None:
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = False


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one lazily loaded from ``DT_FAULT_PLAN``
    (inline JSON, or ``@/path`` to a JSON file) — how subprocess workers
    pick up the chaos harness's plan."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is not None or _ENV_CHECKED:
        return _PLAN
    with _ENV_LOCK:
        if _ENV_CHECKED:
            return _PLAN
        spec = config.env("DT_FAULT_PLAN")
        if spec:
            text = open(spec[1:]).read() if spec.startswith("@") else spec
            _PLAN = FaultPlan.from_json(text)
        _ENV_CHECKED = True
    return _PLAN


def crash_point(site: str, host: Optional[str] = None, **ctx: Any) -> None:
    """Named crash hook; a no-op unless an active plan has a matching
    crash rule.  Call sites are the instrumentation points listed in the
    module docstring."""
    plan = active_plan()
    if plan is not None:
        plan.crash(site, host=host, **ctx)


def delay_point(site: str, host: Optional[str] = None,
                scale: float = 1.0) -> float:
    """Named delay hook (site-scoped ``delay`` rules, r14): a no-op
    unless an active plan has a matching rule.  Returns seconds slept —
    the chaos harness's straggler plan scales it by the worker's live
    batch share so rebalancing measurably recovers step rate."""
    plan = active_plan()
    if plan is None:
        return 0.0
    return plan.delay_at(site, host=host, scale=scale)


def stall_point(site: str, host: Optional[str] = None) -> None:
    """Named stall hook (site-scoped ``stall`` rules, r16): a no-op
    unless an active plan has a matching rule — in which case this call
    NEVER RETURNS (the thread blocks in :meth:`FaultPlan.stall_at`
    forever).  The fit loop hooks ``worker.step`` so the blackbox hang
    watchdog's detection/blame path can be *caused* deterministically
    (``chaos_run --plan hang``)."""
    plan = active_plan()
    if plan is not None:
        plan.stall_at(site, host=host)


def nan_point(site: str, host: Optional[str] = None, **ctx: Any) -> int:
    """Named nan-injection hook (site-scoped ``nan`` rules, r15): a
    no-op returning 0 unless an active plan has a matching rule.  The
    call site poisons its value when the return is non-zero —
    ``Module.fit`` hooks ``worker.grad`` so the r15 health sentinel's
    detection/halt path can be *caused* deterministically
    (``chaos_run --plan nan``)."""
    plan = active_plan()
    if plan is None:
        return 0
    return plan.nan_at(site, host=host, **ctx)
