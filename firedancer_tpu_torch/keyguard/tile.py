"""Sign tile: the only holder of the identity key (copy of the JAX
package's keyguard/tile.py; signing with the port's utils/ed25519_ref).

Every client tile gets a DEDICATED request/response ring pair with a
fixed role, so authorization policy is attached to the wire, not the
payload (ref: src/disco/sign/fd_sign_tile.c — one in/out link pair per
client tile, role fixed at topology build; src/disco/keyguard/
fd_keyguard_client.h — the client side).

Wire format:
  request   u8 sign_type | payload          (frag sig = request id)
  response  u8 ok | 64B signature if ok=1   (frag sig echoes request id)

A refused request gets an explicit ok=0 response (the reference logs and
drops; an explicit NAK keeps the client from blocking forever and is
observable in tests).
"""
from __future__ import annotations

import hashlib
import time

from ..runtime import CNC_RUN
from ..utils.ed25519_ref import keypair, sign
from .keyguard import SIGN_TYPE_ED25519, SIGN_TYPE_SHA256_ED25519, authorize


class SignTile:
    """Core loop logic over (role, in_ring, out_ring, out_fseqs) client
    legs; adapter-agnostic so tests can drive it in-process."""

    def __init__(self, seed: bytes, clients: list[dict]):
        """clients: {role: int, in_ring, out_ring, out_fseqs}."""
        self.seed = seed
        _, _, self.pubkey = keypair(seed)
        self.clients = clients
        self.seqs = [0] * len(clients)
        self.metrics = {"signed": 0, "refused": 0, "overruns": 0,
                        "backpressure": 0}

    def _sign(self, sign_type: int, payload: bytes) -> bytes:
        if sign_type == SIGN_TYPE_SHA256_ED25519:
            payload = hashlib.sha256(payload).digest()
        return sign(self.seed, payload)

    def poll_once(self) -> int:
        total = 0
        for ci, c in enumerate(self.clients):
            ring, out = c["in_ring"], c["out_ring"]
            n, self.seqs[ci], buf, sizes, sigs, ovr = ring.gather(
                self.seqs[ci], 16, ring.mtu)
            self.metrics["overruns"] += ovr
            for i in range(n):
                frame = bytes(buf[i, :sizes[i]])
                if not frame:
                    continue
                sign_type, payload = frame[0], frame[1:]
                if sign_type in (SIGN_TYPE_ED25519,
                                 SIGN_TYPE_SHA256_ED25519) and authorize(
                        self.pubkey, payload, c["role"], sign_type):
                    resp = b"\x01" + self._sign(sign_type, payload)
                    self.metrics["signed"] += 1
                else:
                    resp = b"\x00"
                    self.metrics["refused"] += 1
                while c["out_fseqs"] and out.credits(c["out_fseqs"]) <= 0:
                    self.metrics["backpressure"] += 1
                    time.sleep(20e-6)
                out.publish(resp, sig=int(sigs[i]))
            total += n
        return total

    def in_seqs(self):
        return {i: s for i, s in enumerate(self.seqs)}


class SignHalted(Exception):
    """The client's tile left RUN while a request waited."""


class KeyguardClient:
    """Blocking request/response signing client (the fd_keyguard_client
    pattern): publish a request, spin on the response ring until the
    echoed request id appears. Given its tile's `cnc`, a wait raises
    SignHalted once the tile leaves RUN: a topology halts every tile at
    once, and the sign tile may be gone before it answers."""

    def __init__(self, req_ring, resp_ring, req_fseqs=None, cnc=None):
        self.req = req_ring
        self.resp = resp_ring
        self.req_fseqs = req_fseqs or []
        self.cnc = cnc
        self.resp_seq = 0
        self.next_id = 0

    def _wait(self):
        if self.cnc is not None and self.cnc.state != CNC_RUN:
            raise SignHalted("the tile halted while a sign request waited")

    def sign(self, payload: bytes,
             sign_type: int = SIGN_TYPE_ED25519,
             timeout_s: float = 30.0) -> bytes | None:
        """Returns the 64-byte signature, or None if refused."""
        rid = self.next_id
        self.next_id += 1
        while self.req_fseqs and self.req.credits(self.req_fseqs) <= 0:
            self._wait()
            time.sleep(20e-6)
        self.req.publish(bytes([sign_type]) + payload, sig=rid)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            n, self.resp_seq, buf, sizes, sigs, _ = self.resp.gather(
                self.resp_seq, 8, self.resp.mtu)
            for i in range(n):
                if int(sigs[i]) == rid:
                    frame = bytes(buf[i, :sizes[i]])
                    return frame[1:65] if frame[:1] == b"\x01" else None
            if not n:
                self._wait()
                time.sleep(50e-6)
        raise TimeoutError("sign request timed out")
