"""Solana gossip WIRE codec, the real cluster formats (copy of the JAX
package's flamenco/gossip_wire.py).

Everything here is byte-compatible with Agave's bincode layouts as
specified by the reference's zero-copy parser/serializer
(ref: src/flamenco/gossip/fd_gossip_msg_parse.c, fd_gossip_msg_ser.c,
fd_gossip_private.h) — each function cites the parse routine it
mirrors. The in-memory protocol logic (gossip/protocol.py, crds.py)
speaks THESE encodings on the UDP wire; two fdtpu nodes — or an fdtpu
node and a real cluster peer — exchange identical bytes.

Message envelope (u32 LE enum, fd_gossip_private.h:29-35):
  0 PullRequest(CrdsFilter, CrdsValue)
  1 PullResponse(from: Pubkey, Vec<CrdsValue>)
  2 PushMessage(from: Pubkey, Vec<CrdsValue>)
  3 PruneMessage(from: Pubkey, PruneData)
  4 Ping { from, token[32], signature }
  5 Pong { from, hash[32], signature }

CrdsValue = signature[64] ++ u32 LE tag ++ variant payload; the
signature covers (tag ++ payload) and the value identity hash is
sha256 over the whole serialized value (Agave CrdsValue semantics, as
consumed by fd_gossip_msg_crds_vals_parse:615-621).

Where the copy differs from the reference: `parse_message` refuses a
PruneMessage whose origin count runs past the datagram before it builds
the origin list (the reference builds a list of that many slices first,
and a count near 2^64 holds its parser for as long as that takes); a
datagram that both accept parses to the same view.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

MTU = 1232                      # FD_GOSSIP_MTU
MSG_PULL_REQUEST = 0
MSG_PULL_RESPONSE = 1
MSG_PUSH = 2
MSG_PRUNE = 3
MSG_PING = 4
MSG_PONG = 5

# CRDS discriminants (fd_gossip_private.h:37-51)
V_LEGACY_CONTACT_INFO = 0
V_VOTE = 1
V_LOWEST_SLOT = 2
V_LEGACY_SNAPSHOT_HASHES = 3
V_ACCOUNT_HASHES = 4
V_EPOCH_SLOTS = 5
V_LEGACY_VERSION = 6
V_VERSION = 7
V_NODE_INSTANCE = 8
V_DUPLICATE_SHRED = 9
V_INC_SNAPSHOT_HASHES = 10
V_CONTACT_INFO = 11
V_RESTART_LAST_VOTED_FORK_SLOTS = 12
V_RESTART_HEAVIEST_FORK = 13

MAX_CRDS_PER_MSG = 18           # FD_GOSSIP_MSG_MAX_CRDS
VOTE_IDX_MAX = 32               # FD_GOSSIP_VOTE_IDX_MAX
WALLCLOCK_MAX_MS = 1_000_000_000_000_000

# ContactInfo socket tags (fd_gossip_types.h:47-61)
SOCKET_GOSSIP = 0
SOCKET_SERVE_REPAIR_QUIC = 1
SOCKET_RPC = 2
SOCKET_RPC_PUBSUB = 3
SOCKET_SERVE_REPAIR = 4
SOCKET_TPU = 5
SOCKET_TPU_FORWARDS = 6
SOCKET_TPU_FORWARDS_QUIC = 7
SOCKET_TPU_QUIC = 8
SOCKET_TPU_VOTE = 9
SOCKET_TVU = 10
SOCKET_TVU_QUIC = 11
SOCKET_TPU_VOTE_QUIC = 12
SOCKET_ALPENGLOW = 13
SOCKET_CNT = 14

CLIENT_FIREDANCER = 5           # FD_CONTACT_INFO_VERSION_CLIENT_*


class WireError(ValueError):
    pass


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def enc_varint(v: int) -> bytes:
    """LEB128 7-bit varint (serde_varint; decode mirror:
    fd_gossip_msg_parse.c decode_u64_varint)."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def dec_varint(b: bytes, off: int) -> tuple[int, int]:
    value = 0
    shift = 0
    while off < len(b):
        byte = b[off]
        off += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, off
        shift += 7
        if shift >= 64:
            raise WireError("varint overlong")
    raise WireError("varint truncated")


# compact_u16 is the same 7-bit groups scheme capped at 3 bytes
enc_cu16 = enc_varint


def dec_cu16(b: bytes, off: int) -> tuple[int, int]:
    v, end = dec_varint(b, off)
    if end - off > 3 or v > 0xFFFF:
        raise WireError("compact_u16 out of range")
    return v, end


def _ip4(addr: str | int) -> int:
    if isinstance(addr, int):
        return addr
    p = [int(x) for x in addr.split(".")]
    return p[0] | (p[1] << 8) | (p[2] << 16) | (p[3] << 24)  # LE u32 load


def _ip4_str(v: int) -> str:
    return ".".join(str((v >> (8 * i)) & 0xFF) for i in range(4))


# ---------------------------------------------------------------------------
# CRDS variant payloads
# ---------------------------------------------------------------------------

@dataclass
class ContactInfo:
    """CrdsData::ContactInfo(11) — the v2 contact info
    (fd_gossip_msg_crds_contact_info_parse). sockets: tag -> (ip4
    dotted-quad or int, port host-order)."""
    pubkey: bytes
    wallclock_ms: int
    outset_us: int = 0            # instance creation, micros
    shred_version: int = 0
    version: tuple = (0, 6, 0)    # (major, minor, patch)
    commit: int = 0
    feature_set: int = 0
    client: int = CLIENT_FIREDANCER
    sockets: dict = field(default_factory=dict)
    extensions: tuple = ()

    def encode(self) -> bytes:
        out = bytearray(self.pubkey)
        out += enc_varint(self.wallclock_ms)
        out += struct.pack("<QH", self.outset_us, self.shred_version)
        out += enc_cu16(self.version[0]) + enc_cu16(self.version[1]) \
            + enc_cu16(self.version[2])
        out += struct.pack("<II", self.commit, self.feature_set)
        out += enc_cu16(self.client)
        # dedup addresses preserving first-seen order
        addrs: list[int] = []
        entries = []                        # (tag, addr_idx, port)
        for tag in sorted(self.sockets):
            ip, port = self.sockets[tag]
            ipv = _ip4(ip)
            if ipv not in addrs:
                addrs.append(ipv)
            entries.append((tag, addrs.index(ipv), port))
        out += enc_cu16(len(addrs))
        for ipv in addrs:
            out += struct.pack("<II", 0, ipv)      # IpAddr::V4 variant
        # ports are delta-encoded in entry order (parse: cur_port+=off)
        out += enc_cu16(len(entries))
        cur = 0
        for tag, ai, port in entries:
            out += bytes([tag, ai]) + enc_cu16((port - cur) & 0xFFFF)
            cur = port
        out += enc_cu16(len(self.extensions))
        for e in self.extensions:
            out += struct.pack("<I", e)
        return bytes(out)

    @classmethod
    def decode(cls, b: bytes, off: int) -> tuple["ContactInfo", int]:
        pubkey = bytes(b[off:off + 32])
        if len(pubkey) != 32:
            raise WireError("truncated pubkey")
        off += 32
        wallclock, off = dec_varint(b, off)
        if wallclock >= WALLCLOCK_MAX_MS:
            raise WireError("wallclock out of range")
        outset, shred_version = struct.unpack_from("<QH", b, off)
        off += 10
        major, off = dec_cu16(b, off)
        minor, off = dec_cu16(b, off)
        patch, off = dec_cu16(b, off)
        commit, feature_set = struct.unpack_from("<II", b, off)
        off += 8
        client, off = dec_cu16(b, off)
        addrs_len, off = dec_cu16(b, off)
        if addrs_len > 102:                 # MAX_ADDRESSES
            raise WireError("too many addresses")
        addrs = []
        for _ in range(addrs_len):
            (is_ip6,) = struct.unpack_from("<I", b, off)
            off += 4
            if is_ip6 & 0xFF:
                off += 16
                addrs.append(None)          # ipv6 unsupported, skipped
            else:
                (ipv,) = struct.unpack_from("<I", b, off)
                off += 4
                addrs.append(ipv)
        sockets_len, off = dec_cu16(b, off)
        if sockets_len > 256:               # MAX_SOCKETS
            raise WireError("too many sockets")
        sockets = {}
        cur = 0
        seen = set()
        for _ in range(sockets_len):
            tag, ai = b[off], b[off + 1]
            off += 2
            delta, off = dec_cu16(b, off)
            cur = (cur + delta) & 0xFFFF
            if tag in seen:
                raise WireError("duplicate socket tag")
            seen.add(tag)
            if ai >= addrs_len:
                raise WireError("addr idx out of range")
            if tag < SOCKET_CNT and addrs[ai] is not None:
                sockets[tag] = (_ip4_str(addrs[ai]), cur)
        ext_len, off = dec_cu16(b, off)
        ext = struct.unpack_from("<%dI" % ext_len, b, off)
        off += 4 * ext_len
        return cls(pubkey, wallclock, outset, shred_version,
                   (major, minor, patch), commit, feature_set, client,
                   sockets, tuple(ext)), off

    def gossip_addr(self):
        s = self.sockets.get(SOCKET_GOSSIP)
        return s if s and s[1] else None


def encode_vote(index: int, pubkey: bytes, txn: bytes,
                wallclock_ms: int) -> bytes:
    """CrdsData::Vote(1): u8 index + pubkey + full vote txn + u64
    wallclock ms (fd_gossip_msg_crds_vote_parse)."""
    if not 0 <= index < VOTE_IDX_MAX:
        raise WireError("vote index out of range")
    return bytes([index]) + pubkey + txn \
        + struct.pack("<Q", wallclock_ms)


def decode_vote(b: bytes, off: int) -> tuple[dict, int]:
    from ..protocol.txn import parse_txn
    index = b[off]
    if index >= VOTE_IDX_MAX:
        raise WireError("vote index out of range")
    pubkey = bytes(b[off + 1:off + 33])
    # the txn length is discovered by parsing it (the reference calls
    # fd_txn_parse_core, fd_gossip_msg_crds_vote_parse:114)
    body = bytes(b[off + 33:])
    txn = parse_txn(body, allow_trailing=True)
    txn_sz = txn.size
    p = off + 33 + txn_sz
    (wallclock,) = struct.unpack_from("<Q", b, p)
    if wallclock >= WALLCLOCK_MAX_MS:
        raise WireError("wallclock out of range")
    return {"index": index, "pubkey": pubkey,
            "txn": body[:txn_sz], "wallclock_ms": wallclock}, p + 8


def encode_node_instance(pubkey: bytes, wallclock_ms: int,
                         timestamp: int, token: int) -> bytes:
    """CrdsData::NodeInstance(8) (fd_gossip_msg_crds_node_instance_parse)."""
    return pubkey + struct.pack("<QQQ", wallclock_ms, timestamp, token)


def decode_node_instance(b: bytes, off: int) -> tuple[dict, int]:
    pubkey = bytes(b[off:off + 32])
    wallclock, ts, token = struct.unpack_from("<QQQ", b, off + 32)
    if wallclock >= WALLCLOCK_MAX_MS:
        raise WireError("wallclock out of range")
    return {"pubkey": pubkey, "wallclock_ms": wallclock,
            "timestamp": ts, "token": token}, off + 56


def encode_lowest_slot(pubkey: bytes, lowest: int,
                       wallclock_ms: int) -> bytes:
    """CrdsData::LowestSlot(2) with the deprecated vectors empty
    (fd_gossip_msg_crds_lowest_slot_parse)."""
    return bytes([0]) + pubkey + struct.pack("<QQQQ", 0, lowest, 0, 0) \
        + struct.pack("<Q", wallclock_ms)


def decode_lowest_slot(b: bytes, off: int) -> tuple[dict, int]:
    if b[off]:
        raise WireError("lowest_slot ix != 0")
    pubkey = bytes(b[off + 1:off + 33])
    root, lowest, slots_len = struct.unpack_from("<QQQ", b, off + 33)
    if slots_len:
        raise WireError("deprecated slots set non-empty")
    (stash_len,) = struct.unpack_from("<Q", b, off + 57)
    if stash_len:
        raise WireError("deprecated stash non-empty")
    (wallclock,) = struct.unpack_from("<Q", b, off + 65)
    return {"pubkey": pubkey, "lowest": lowest, "root": root,
            "wallclock_ms": wallclock}, off + 73


# ---------------------------------------------------------------------------
# CRDS value envelope
# ---------------------------------------------------------------------------

def signable(tag: int, payload: bytes) -> bytes:
    """What the origin signs: serialize(CrdsData) = u32 tag + payload
    (verify_crds_value in fd_gossvf_tile.c:341-349 verifies exactly
    the bytes after the signature)."""
    return struct.pack("<I", tag) + payload


def encode_value(tag: int, payload: bytes, signature: bytes) -> bytes:
    return signature + struct.pack("<I", tag) + payload


def value_hash(wire: bytes) -> bytes:
    """CRDS identity hash: sha256 over the serialized value
    (signature included) — the key pull-request blooms filter on."""
    return hashlib.sha256(wire).digest()


_PUBKEY_OFF = {                  # payload offset of the origin pubkey
    V_LEGACY_CONTACT_INFO: 0, V_VOTE: 1, V_LOWEST_SLOT: 1,
    V_LEGACY_SNAPSHOT_HASHES: 0, V_ACCOUNT_HASHES: 0, V_EPOCH_SLOTS: 1,
    V_LEGACY_VERSION: 0, V_VERSION: 0, V_NODE_INSTANCE: 0,
    V_DUPLICATE_SHRED: 2, V_INC_SNAPSHOT_HASHES: 0, V_CONTACT_INFO: 0,
    V_RESTART_LAST_VOTED_FORK_SLOTS: 0, V_RESTART_HEAVIEST_FORK: 0,
}


def _payload_size(tag: int, b: bytes, off: int) -> int:
    """Byte length of a variant payload starting at off — the value
    boundary scan containers need (fd_gossip_msg_crds_data_parse)."""
    start = off
    if tag == V_CONTACT_INFO:
        _, end = ContactInfo.decode(b, off)
        return end - start
    if tag == V_VOTE:
        _, end = decode_vote(b, off)
        return end - start
    if tag == V_NODE_INSTANCE:
        return 56
    if tag == V_LOWEST_SLOT:
        _, end = decode_lowest_slot(b, off)
        return end - start
    if tag == V_LEGACY_VERSION or tag == V_VERSION:
        # pubkey + wallclock + 3 u16 + Option<u32 commit> [+ u32]
        p = off + 32 + 8 + 6
        has_commit = b[p]
        p += 1 + (4 if has_commit else 0)
        if tag == V_VERSION:
            p += 4
        return p - start
    if tag == V_LEGACY_CONTACT_INFO:
        p = off + 32
        for _ in range(10):
            (is6,) = struct.unpack_from("<I", b, p)
            p += 4 + (6 if not is6 else 26)
        return p + 10 - start          # + wallclock u64 + shred u16
    if tag in (V_LEGACY_SNAPSHOT_HASHES, V_ACCOUNT_HASHES):
        # pubkey + Vec<(u64 slot, 32B hash)> + wallclock
        (n,) = struct.unpack_from("<Q", b, off + 32)
        return 32 + 8 + 40 * n + 8
    if tag == V_INC_SNAPSHOT_HASHES:
        # pubkey + full (u64+32) + Vec<(u64+32)> incremental + wallclock
        (n,) = struct.unpack_from("<Q", b, off + 72)
        return 32 + 40 + 8 + 40 * n + 8
    if tag == V_EPOCH_SLOTS:
        # u8 index + pubkey + Vec<CompressedSlots> + wallclock
        p = off + 33
        (n,) = struct.unpack_from("<Q", b, p)
        p += 8
        for _ in range(n):
            (uncompressed,) = struct.unpack_from("<I", b, p)
            p += 4
            if uncompressed:
                p += 16                  # first_slot + num
                if b[p]:                 # BitVec<u8>: Option + len
                    (cap,) = struct.unpack_from("<Q", b, p + 1)
                    p += 1 + 8 + cap + 8
                else:
                    p += 1
            else:
                (clen,) = struct.unpack_from("<Q", b, p + 16)
                p += 24 + clen
        return p + 8 - start
    if tag == V_DUPLICATE_SHRED:
        # u16 idx + pubkey + wallclock + slot + 5B + num/idx + chunk
        (clen,) = struct.unpack_from("<Q", b, off + 57)
        return 2 + 32 + 8 + 8 + 5 + 2 + 8 + clen
    if tag == V_RESTART_LAST_VOTED_FORK_SLOTS:
        p = off + 40
        (raw,) = struct.unpack_from("<I", b, p)
        p += 4
        if not raw:
            (n,) = struct.unpack_from("<Q", b, p)
            p += 8 + 4 * n               # RunLengthEncoding<u32>
        else:
            if b[p]:
                (cap,) = struct.unpack_from("<Q", b, p + 1)
                p += 1 + 8 + cap + 8
            else:
                p += 1
        return p + 42 - start            # slot + hash + shred_version
    if tag == V_RESTART_HEAVIEST_FORK:
        return 32 + 8 + 8 + 32 + 8 + 2
    raise WireError(f"unsupported CRDS tag {tag}")


def decode_value(b: bytes, off: int) -> tuple[dict, int]:
    """One CrdsValue: returns {signature, tag, payload, origin,
    wallclock_ms, wire} and the end offset
    (fd_gossip_msg_crds_vals_parse:610-622)."""
    sig = bytes(b[off:off + 64])
    if len(sig) != 64:
        raise WireError("truncated signature")
    (tag,) = struct.unpack_from("<I", b, off + 64)
    p = off + 68
    sz = _payload_size(tag, b, p)
    payload = bytes(b[p:p + sz])
    if len(payload) != sz:
        raise WireError("truncated payload")
    pk_off = _PUBKEY_OFF[tag]
    origin = payload[pk_off:pk_off + 32]
    if tag == V_CONTACT_INFO:
        wc, _ = dec_varint(payload, 32)
    elif tag in (V_VOTE, V_LOWEST_SLOT, V_LEGACY_SNAPSHOT_HASHES,
                 V_ACCOUNT_HASHES, V_EPOCH_SLOTS,
                 V_INC_SNAPSHOT_HASHES):
        (wc,) = struct.unpack_from("<Q", payload, sz - 8)
    elif tag in (V_NODE_INSTANCE, V_LEGACY_VERSION, V_VERSION,
                 V_RESTART_LAST_VOTED_FORK_SLOTS,
                 V_RESTART_HEAVIEST_FORK):
        (wc,) = struct.unpack_from("<Q", payload, 32)
    elif tag == V_LEGACY_CONTACT_INFO:
        (wc,) = struct.unpack_from("<Q", payload, sz - 10)
    elif tag == V_DUPLICATE_SHRED:
        (wc,) = struct.unpack_from("<Q", payload, 34)
    else:
        wc = 0
    end = p + sz
    return {"signature": sig, "tag": tag, "payload": payload,
            "origin": bytes(origin), "wallclock_ms": wc,
            "wire": bytes(b[off:end])}, end


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

def encode_container(msg: int, from_pubkey: bytes,
                     values: list[bytes]) -> bytes:
    """Push(2) / PullResponse(1): u32 tag + from + u64 len + values
    (fd_gossip_msg_crds_container_parse)."""
    assert msg in (MSG_PUSH, MSG_PULL_RESPONSE)
    out = struct.pack("<I", msg) + from_pubkey \
        + struct.pack("<Q", len(values))
    return out + b"".join(values)


def encode_pull_request(bloom_keys: list[int], bloom_bits: bytes,
                        bloom_num_bits_set: int, mask: int,
                        mask_bits: int, ci_value: bytes,
                        bits_cnt: int | None = None) -> bytes:
    """PullRequest(0): CrdsFilter { Bloom { keys: Vec<u64>,
    bits: BitVec<u64> (Option<Vec<u64>> + u64 bit len),
    num_bits_set }, mask, mask_bits } + our ContactInfo CrdsValue
    (fd_gossip_pull_req_parse). bits_cnt is the logical bit length
    (<= words*64; defaults to the full capacity)."""
    assert len(bloom_bits) % 8 == 0
    nwords = len(bloom_bits) // 8
    if bits_cnt is None:
        bits_cnt = nwords * 64
    out = struct.pack("<I", MSG_PULL_REQUEST)
    out += struct.pack("<Q", len(bloom_keys))
    out += b"".join(struct.pack("<Q", k & 0xFFFFFFFFFFFFFFFF)
                    for k in bloom_keys)
    out += bytes([1]) + struct.pack("<Q", nwords) + bloom_bits \
        + struct.pack("<Q", bits_cnt)
    out += struct.pack("<QQI", bloom_num_bits_set, mask, mask_bits)
    return out + ci_value


def encode_prune(from_pubkey: bytes, origins: list[bytes],
                 signature: bytes, destination: bytes,
                 wallclock_ms: int) -> bytes:
    """PruneMessage(3): from + PruneData { pubkey, prunes, signature,
    destination, wallclock } (fd_gossip_msg_prune_parse; the outer
    from must equal PruneData.pubkey)."""
    return struct.pack("<I", MSG_PRUNE) + from_pubkey + from_pubkey \
        + struct.pack("<Q", len(origins)) + b"".join(origins) \
        + signature + destination + struct.pack("<Q", wallclock_ms)


def prune_signable(pubkey: bytes, origins: list[bytes],
                   destination: bytes, wallclock_ms: int,
                   prefixed: bool = True) -> bytes:
    """PruneData signable bytes; verifiers accept BOTH the prefixed
    and unprefixed form (fd_gossvf_tile.c verify_prune:321-338)."""
    body = pubkey + struct.pack("<Q", len(origins)) \
        + b"".join(origins) + destination \
        + struct.pack("<Q", wallclock_ms)
    return (b"\xffSOLANA_PRUNE_DATA" + body) if prefixed else body


def encode_ping(from_pubkey: bytes, token: bytes,
                signature: bytes) -> bytes:
    """Ping(4): from + 32B token + signature over the raw token
    (fd_gossip.c:779)."""
    return struct.pack("<I", MSG_PING) + from_pubkey + token + signature


def pong_preimage(token: bytes) -> bytes:
    """Pong hash/signature pre-image: "SOLANA_PING_PONG" + token;
    the pong carries sha256(preimage) and a signature over that hash
    (fd_gossip.c:655-663)."""
    return b"SOLANA_PING_PONG" + token


def encode_pong(from_pubkey: bytes, token: bytes,
                signature: bytes) -> bytes:
    h = hashlib.sha256(pong_preimage(token)).digest()
    return struct.pack("<I", MSG_PONG) + from_pubkey + h + signature


def parse_message(b: bytes) -> dict:
    """Datagram -> typed view (fd_gossip_msg_parse). Raises WireError
    on malformed input; trailing bytes are rejected like the
    reference's payload_sz==CUR_OFFSET check."""
    if len(b) > MTU:
        raise WireError("datagram exceeds gossip MTU")
    (tag,) = struct.unpack_from("<I", b, 0)
    off = 4
    if tag in (MSG_PUSH, MSG_PULL_RESPONSE):
        frm = bytes(b[off:off + 32])
        (n,) = struct.unpack_from("<Q", b, off + 32)
        if n > MAX_CRDS_PER_MSG:
            raise WireError("too many CRDS values")
        off += 40
        values = []
        for _ in range(n):
            v, off = decode_value(b, off)
            values.append(v)
        kind = "push" if tag == MSG_PUSH else "pull_response"
        out = {"kind": kind, "from": frm, "values": values}
    elif tag == MSG_PULL_REQUEST:
        (keys_len,) = struct.unpack_from("<Q", b, off)
        off += 8
        keys = list(struct.unpack_from("<%dQ" % keys_len, b, off))
        off += 8 * keys_len
        has_bits = b[off]
        off += 1
        bits = b""
        if has_bits:
            (nwords,) = struct.unpack_from("<Q", b, off)
            off += 8
            bits = bytes(b[off:off + 8 * nwords])
            if len(bits) != 8 * nwords:
                raise WireError("truncated bloom bits")
            off += 8 * nwords
            (bits_cnt,) = struct.unpack_from("<Q", b, off)
            off += 8
            if bits_cnt > nwords * 64:
                raise WireError("bloom bit len > capacity")
        else:
            raise WireError("bloom without bits")
        num_set, mask = struct.unpack_from("<QQ", b, off)
        (mask_bits,) = struct.unpack_from("<I", b, off + 16)
        off += 20
        ci, off = decode_value(b, off)
        out = {"kind": "pull_request", "bloom_keys": keys,
               "bloom_bits": bits, "bloom_bits_cnt": bits_cnt,
               "bloom_num_bits_set": num_set,
               "mask": mask, "mask_bits": mask_bits, "ci": ci}
    elif tag == MSG_PRUNE:
        frm = bytes(b[off:off + 32])
        pk = bytes(b[off + 32:off + 64])
        if frm != pk:
            raise WireError("prune from != PruneData.pubkey")
        off += 64
        (n,) = struct.unpack_from("<Q", b, off)
        off += 8
        if off + 32 * n > len(b):
            raise WireError("truncated prune origins")
        origins = [bytes(b[off + 32 * i:off + 32 * (i + 1)])
                   for i in range(n)]
        off += 32 * n
        sig = bytes(b[off:off + 64])
        dest = bytes(b[off + 64:off + 96])
        (wc,) = struct.unpack_from("<Q", b, off + 96)
        off += 104
        out = {"kind": "prune", "from": frm, "origins": origins,
               "signature": sig, "destination": dest,
               "wallclock_ms": wc}
    elif tag in (MSG_PING, MSG_PONG):
        frm = bytes(b[off:off + 32])
        tok = bytes(b[off + 32:off + 64])
        sig = bytes(b[off + 64:off + 128])
        if len(sig) != 64:
            raise WireError("truncated ping/pong")
        off += 128
        out = {"kind": "ping" if tag == MSG_PING else "pong",
               "from": frm, "token": tok, "signature": sig}
    else:
        raise WireError(f"unknown message tag {tag}")
    if off != len(b):
        raise WireError("trailing bytes")
    return out
