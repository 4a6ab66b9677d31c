"""The system under test: the port's verification stack, wired the way
``lighthouse_tpu_torch.client.ClientBuilder`` wires it for a node on
``cuda``, and the benchmark's record of its device dispatches.

* the registry's keys in a ``DeviceKeyTable``, attached with
  ``key_table.set_table``;
* a ``CompileService`` over the cell's rungs, attached with
  ``set_service`` (the node's ``compile_rungs``);
* the ``cuda`` backend, ``CudaBackend(device="cuda")``;
* a started ``VerificationScheduler`` at the program's defaults (deadline
  25 ms, batches of up to 256 sets, the flush planner on, bulk flushes of
  512 sets), whose verifier is the program's
  ``bls.verify_signature_sets`` seen through :class:`Dispatches`.

This is the only module of the benchmark that imports the program.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence


class Dispatches:
    """The scheduler's verifier, counted: each call is one device dispatch
    (a fused flush, a sub-batch, a bisection leaf, a ``verify_now``). Each
    record holds its host clock interval, its sets, and what the backend
    says of the batch (``CudaBackend.last_batch``) with the batch's
    padding waste (``bls_device_padding_waste_ratio``)."""

    def __init__(self, verify, backend=None):
        self.verify = verify
        self.backend = backend
        self.rows: List[dict] = []
        self.recording = False
        self._lock = threading.Lock()

    def __call__(self, sets) -> bool:
        t0 = time.perf_counter()
        out = self.verify(sets)
        t1 = time.perf_counter()
        if self.recording:
            row = {"t0": t0, "t1": t1, "n_sets": len(sets)}
            lb = getattr(self.backend, "last_batch", None) or {}
            # another thread's batch may have replaced last_batch: keep
            # it only when it describes this call
            if lb.get("n_sets") == len(sets):
                row.update(resolve_s=lb["resolve_s"], pack_s=lb["pack_s"],
                           stages_s=sum(v for k, v in lb["stages"].items() if k != "gather"),
                           rung=lb["rung"], warm=lb["warm"], collapsed=lb["collapsed"],
                           path=lb["path"], waste=_padding_waste())
            with self._lock:
                self.rows.append(row)
        return out


def _padding_waste() -> Optional[float]:
    from lighthouse_tpu_torch.utils import metrics

    g = metrics.get("bls_device_padding_waste_ratio")
    return None if g is None else float(g.value)


def program_keys(raw_xy: bytes) -> list:
    """The registry as the program's ``PublicKey`` objects."""
    from lighthouse_tpu_torch.crypto.bls import PublicKey
    from lighthouse_tpu_torch.crypto.cpu.curve import G1Point
    from lighthouse_tpu_torch.crypto.cpu.fields import Fq

    fb = int.from_bytes
    return [PublicKey(G1Point(Fq(fb(raw_xy[i:i + 48], "big")), Fq(fb(raw_xy[i + 48:i + 96], "big"))))
            for i in range(0, len(raw_xy), 96)]


def program_sets(specs: Sequence, sigs: Sequence[bytes], keys: list) -> list:
    """The program's ``SignatureSet`` objects, built from the registry's
    own key objects (the key table resolves keys by identity)."""
    from lighthouse_tpu_torch.crypto.bls import Signature, SignatureSet

    return [SignatureSet(Signature.deserialize(sig), [keys[i] for i in s.members], s.msg,
                         list(s.members))
            for s, sig in zip(specs, sigs)]


class Stack:
    """The verification stack on ``device`` over the keys ``keys``."""

    def __init__(self, keys: list, rungs: Sequence, device: str = "cuda", verify=None):
        from lighthouse_tpu_torch.compile_service import CompileService, set_service
        from lighthouse_tpu_torch.crypto import backend as backend_mod
        from lighthouse_tpu_torch.crypto import bls
        from lighthouse_tpu_torch.crypto.device import key_table
        from lighthouse_tpu_torch.verification_service import VerificationScheduler

        backend_mod.set_backend("cuda", device=device)
        self.backend = backend_mod.active()
        self.table = key_table.DeviceKeyTable(SimpleNamespace(pubkeys=keys), device=device)
        self.table.sync(reason="startup")
        key_table.set_table(self.table)
        # no rungs (the tests' stub verifiers): no compile service, whose
        # cold routes would go to its own host verifier
        self.service = None
        if rungs:
            self.service = CompileService(rungs=[tuple(r) for r in rungs], device=device).start()
            set_service(self.service)
        self.dispatches = Dispatches(verify or bls.verify_signature_sets, self.backend)
        self.scheduler = VerificationScheduler(verify_fn=self.dispatches,
                                               compile_service=self.service).start()

    def wait_warm(self, timeout: float = 900.0) -> None:
        if self.service is not None and not self.service.wait_idle(timeout):
            raise RuntimeError(f"the compile service did not finish its rungs in {timeout} s")

    def counters(self) -> Dict:
        """The program's counters that the readers difference over a
        slice: K1-K3 launches and lanes, the key table's sets by path, the
        service's cold routes and fallback calls, the graphs captured."""
        from lighthouse_tpu_torch.crypto.device import kernels

        st = self.table.status()
        out = {"kernels": kernels.snapshot(), "table_sets": dict(st["sets"]),
               "agg_sum_s": st["aggregate_sum_seconds"]}
        if self.service is not None:
            svc = self.service.status()
            out.update(cold_routes=dict(svc["cold_routes"]), fallback_calls=svc["fallback"]["calls"],
                       captures=svc["compiled_total"], graphs=svc["graphs"]["graphs"])
        return out

    def bulk_chain(self):
        """What ``verification_service.backend_verify_bulk`` takes for a
        chain: the object that holds the scheduler."""
        return SimpleNamespace(verification_scheduler=self.scheduler)

    def close(self) -> None:
        from lighthouse_tpu_torch.compile_service import clear_service
        from lighthouse_tpu_torch.crypto.device import key_table

        flusher = self.scheduler._thread
        self.scheduler.stop()
        if flusher is not None:
            # stop() waits 10 s; a backlog drains for as long as it needs
            flusher.join(timeout=300)
        if self.service is not None:
            self.service.stop()
            clear_service(self.service)
        key_table.clear_table(self.table)
        self.table.close()
