"""Account DB facade over funk (copy of the JAX package's svm/accdb.py:
`Account`, `RwHandle`, the `AccDb` facade and `commit_lamports`; ref:
src/flamenco/accdb/fd_accdb_user.h — the peek/open_ro/open_rw/close
vtable, fork depth <= 128).

Accounts are typed records (lamports, data, owner, executable,
rent_epoch — the Solana account shape, ref: src/flamenco/types account
meta) stored as funk record values, so every fork/publish/cancel
semantic is inherited from the funk transaction tree.

Handle discipline mirrors the vtable: peek is a borrow (no copy —
callers must not mutate), open_ro a defensive copy, open_rw a
copy-on-write handle that only lands in the fork on close_rw (so a
failed transaction simply drops its handles — the runtime's rollback
unit). Active-handle counts are tracked like the reference's
rw_active/ro_active for leak detection in tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..funk.funk import key32

DEPTH_MAX = 128                      # ref: FD_ACCDB_DEPTH_MAX
SYSTEM_PROGRAM_ID = bytes(32)


@dataclass
class Account:
    lamports: int = 0
    data: bytes = b""
    owner: bytes = SYSTEM_PROGRAM_ID
    executable: bool = False
    rent_epoch: int = 0


@dataclass
class RwHandle:
    pubkey: bytes
    xid: object
    account: Account
    created: bool = False
    _closed: bool = field(default=False, repr=False)


class AccDb:
    def __init__(self, funk):
        self.funk = funk
        self.ro_active = 0
        self.rw_active = 0

    # -- reads --------------------------------------------------------------

    def peek(self, xid, pubkey: bytes) -> Account | None:
        """Borrow: the caller MUST NOT mutate or hold across a write
        (ref: fd_accdb_peek_t semantics). Legacy bare-int records (the
        genesis lamports path) read as balance-only system Accounts, so
        a funded key is never mistaken for absent — an open_rw over one
        upgrades it to a typed record on close."""
        v = self.funk.rec_query(xid, pubkey)
        if isinstance(v, Account):
            return v
        if isinstance(v, int):
            return Account(lamports=v)
        return None

    def open_ro(self, xid, pubkey: bytes) -> Account | None:
        acct = self.peek(xid, pubkey)
        if acct is None:
            return None
        self.ro_active += 1
        return replace(acct)

    def close_ro(self, acct: Account):
        self.ro_active -= 1

    # -- writes -------------------------------------------------------------

    def open_rw(self, xid, pubkey: bytes,
                do_create: bool = False) -> RwHandle | None:
        """Copy-on-write handle; mutations land in fork `xid` only on
        close_rw. do_create materializes a fresh system account
        (ref: open_rw's do_create flag)."""
        acct = self.peek(xid, pubkey)
        created = False
        if acct is None:
            if not do_create:
                return None
            acct = Account()
            created = True
        self.rw_active += 1
        return RwHandle(pubkey, xid, replace(acct), created)

    def close_rw(self, h: RwHandle, discard: bool = False):
        if h._closed:
            raise RuntimeError("double close of rw handle")
        h._closed = True
        self.rw_active -= 1
        if not discard:
            self.funk.rec_write(h.xid, key32(h.pubkey), h.account)

    # -- convenience (the hot SVM path) -------------------------------------

    def lamports(self, xid, pubkey: bytes) -> int:
        a = self.peek(xid, pubkey)
        return 0 if a is None else a.lamports

    def set_lamports(self, xid, pubkey: bytes, lamports: int):
        """Fast-path balance commit used by the wave executor: preserves
        the rest of the account record, creating system accounts on
        first credit."""
        a = self.peek(xid, pubkey)
        a = Account() if a is None else replace(a)
        a.lamports = lamports
        self.funk.rec_write(xid, key32(pubkey), a)


def commit_lamports(funk, xid, pubkey: bytes, lamports: int,
                    typed: bool, prior):
    """THE one place deciding the funk value convention for balance
    commits (the wave executor's write-back). typed mode (any account in
    the block is accdb-typed) always lands Account records — including
    creations and upgrades of legacy int records, which carry only a
    balance; legacy mode (pure-int block) keeps bare lamport ints."""
    if typed:
        rec = replace(prior, lamports=lamports) \
            if isinstance(prior, Account) else Account(lamports=lamports)
    else:
        rec = lamports
    funk.rec_write(xid, key32(pubkey), rec)
