"""Genesis: a cluster's slot-0 state (copy of the JAX package's
app/genesis.py: `validator_seed`, `build_genesis` and the CLI).

The reference's genesi tile materializes genesis (funded accounts,
vote + stake accounts for the boot validator set) that every node
restores before slot 0 (ref: src/discof/genesi/ and the fd_genesis
create path). This builds the same artifact:

  * funded payer/user accounts (the deterministic synth signer pool)
  * per-validator: an initialized VOTE account (node identity =
    authorized voter = the validator's pubkey) and a DELEGATED stake
    account (active from epoch 1), so flamenco/stakes.py derives a
    non-empty leader schedule, turbine weights, and tower total from
    slot 0
  * output: a legacy funk checkpoint (utils/checkpt.funk_checkpt, no
    metadata) that a bank's `genesis_ckpt` restores and snapld/snapin
    restore as slot 0 with a zero bank hash, plus the derived epoch-1
    stakes

It is host work only: no kernel runs, so it takes no `device`. The
checkpoint is byte for byte the reference's for the same arguments.

CLI:
  python -m firedancer_tpu_torch.app.genesis out.ckpt \\
      --validators 3 --user-accounts 16 --stake 1000000
"""
from __future__ import annotations

import argparse
import hashlib
import sys

from ..funk.funk import Funk, key32
from ..svm.accdb import Account
from ..svm.stake import STAKE_PROGRAM_ID, ST_DELEGATED, StakeState
from ..svm.vote import VOTE_PROGRAM_ID, VoteState


def validator_seed(i: int) -> bytes:
    return hashlib.sha256(b"fdtpu-validator-%d" % i).digest()


def build_genesis(n_validators: int = 3, n_user_accounts: int = 16,
                  stake: int = 1_000_000,
                  user_lamports: int = 1 << 44) -> tuple[Funk, list]:
    """-> (funk, [(identity_pub, vote_key, stake_key)])."""
    from ..disco.tiles import _synth_genesis
    from ..utils.ed25519_ref import keypair
    funk = Funk()
    validators = []
    for i in range(n_validators):
        _, _, identity = keypair(validator_seed(i))
        vote_key = hashlib.sha256(b"vote" + identity).digest()
        stake_key = hashlib.sha256(b"stake" + identity).digest()
        vs = VoteState(identity, identity, identity)
        funk.rec_write(None, vote_key, Account(
            lamports=1, data=vs.to_bytes(), owner=VOTE_PROGRAM_ID))
        st = StakeState(ST_DELEGATED, staker=identity,
                        withdrawer=identity, voter=vote_key,
                        amount=stake, activation_epoch=0)
        funk.rec_write(None, stake_key, Account(
            lamports=stake, data=st.to_bytes(),
            owner=STAKE_PROGRAM_ID))
        funk.rec_write(None, key32(identity), Account(
            lamports=user_lamports))
        validators.append((identity, vote_key, stake_key))
    # user accounts come from THE shared synth-genesis map (the same
    # one the bank/replay tiles derive); the pool is finite and wraps,
    # so an oversized request is an error, not a silent cap
    users = _synth_genesis(n_user_accounts)
    if len(users) < n_user_accounts:
        raise ValueError(
            f"user-accounts capped at {len(users)} (the deterministic "
            f"synth signer pool wraps); requested {n_user_accounts}")
    for pub in users:
        funk.rec_write(None, key32(pub), Account(lamports=user_lamports))
    return funk, validators


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="firedancer_tpu_torch genesis")
    ap.add_argument("out", help="output checkpoint path")
    ap.add_argument("--validators", type=int, default=3)
    ap.add_argument("--user-accounts", type=int, default=16)
    ap.add_argument("--stake", type=int, default=1_000_000)
    args = ap.parse_args(argv)

    from ..flamenco.stakes import node_stakes
    from ..utils.checkpt import funk_checkpt
    funk, validators = build_genesis(args.validators,
                                     args.user_accounts, args.stake)
    with open(args.out, "wb") as f:
        funk_checkpt(funk, f)
    ns = node_stakes(funk, None, 1)
    print(f"genesis: {len(funk.root_items())} accounts, "
          f"{len(validators)} validators")
    for ident, vote, stake_key in validators:
        print(f"  identity {ident.hex()[:16]}.. vote {vote.hex()[:16]}"
              f".. stake@1 {ns.get(ident, 0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
