"""The account record and the wave executor's balance write-back (copy of
`Account` and `commit_lamports` of the JAX package's svm/accdb.py:27,
:116; the AccDb facade and its handles come with exec="general",
ROADMAP.md queue A item 15).

Accounts are typed records (lamports, data, owner, executable,
rent_epoch — the Solana account shape, ref: src/flamenco/types account
meta) stored as funk record values, so every fork/publish/cancel
semantic is inherited from the funk transaction tree.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from ..funk.funk import key32

SYSTEM_PROGRAM_ID = bytes(32)


@dataclass
class Account:
    lamports: int = 0
    data: bytes = b""
    owner: bytes = SYSTEM_PROGRAM_ID
    executable: bool = False
    rent_epoch: int = 0


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
