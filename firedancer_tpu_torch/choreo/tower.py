"""TowerBFT vote tower (copy of the JAX package's choreo/tower.py;
ref: src/choreo/tower/fd_tower.h — the long
tutorial comment defines every rule implemented here; state transitions
ref: src/choreo/tower/fd_tower.c:30-100 simulate_vote/push_vote).

The tower is a deque of (slot, conf) votes, newest at the top:

  lockout(vote)    = 2^conf
  expiration(vote) = slot + lockout

Voting for S first pops votes whose expiration < S, top-down and
contiguously (a surviving vote shields everything below it), then
increments conf for the still-consecutive run under the new vote
("doubling lockouts"), then pushes (S, 1). When the tower is full
(max_lockout_history votes) after expiry, the bottom vote roots and
pops — rooting drives state pruning everywhere else (ghost.publish,
funk publish; ref: fd_tower.h rooting discussion).

Checks (ref: fd_tower.c:14-16 THRESHOLD_DEPTH 8, THRESHOLD_RATIO 2/3,
SWITCH_RATIO 0.38):

  lockout_check    may not vote for a different fork than vote v until
                   slot > expiration(v); fork identity via ghost
  threshold_check  the vote at depth 8 (after simulated expiry) must be
                   supported by >= 2/3 of stake's latest votes
  switch_check     >= 38% of stake must sit on forks branching off the
                   GCA(last_vote, switch_target) other than our own
                   (the fd_tower.h switch-check diagram: subtrees of the
                   GCA excluding the child containing our last vote)
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .ghost import Ghost

MAX_LOCKOUT_HISTORY = 31
THRESHOLD_DEPTH = 8
THRESHOLD_RATIO = 2.0 / 3.0
SWITCH_RATIO = 0.38


@dataclass
class TowerVote:
    slot: int
    conf: int

    @property
    def lockout(self) -> int:
        return 1 << self.conf

    @property
    def expiration(self) -> int:
        return self.slot + self.lockout


class Tower:
    def __init__(self, max_lockout_history: int = MAX_LOCKOUT_HISTORY):
        self.votes: deque[TowerVote] = deque()   # [0] oldest ... [-1] newest
        self.max = max_lockout_history
        self.root: int | None = None

    # -- state transitions --------------------------------------------------

    def simulate(self, slot: int) -> int:
        """Surviving vote count were we to vote for slot: expire from the
        top while expiration < slot; a surviving vote stops the scan
        (top-down contiguous expiry, ref: fd_tower.c simulate_vote)."""
        cnt = len(self.votes)
        while cnt and self.votes[cnt - 1].expiration < slot:
            cnt -= 1
        return cnt

    def vote(self, slot: int) -> int | None:
        """Apply a vote; returns the newly-rooted slot, if any."""
        if self.votes and slot <= self.votes[-1].slot:
            raise ValueError(f"vote {slot} <= last {self.votes[-1].slot}")
        cnt = self.simulate(slot)
        while len(self.votes) > cnt:
            self.votes.pop()
        rooted = None
        if len(self.votes) >= self.max:      # bottom vote reaches max lockout
            rooted = self.votes.popleft().slot
            self.root = rooted
        # double lockouts for the consecutive run under the new vote:
        # from the top, conf must read 1, 2, 3, ... to keep doubling
        # (ref: fd_tower.c push_vote rev iteration)
        expect = 0
        for v in reversed(self.votes):
            expect += 1
            if v.conf != expect:
                break
            v.conf += 1
        self.votes.append(TowerVote(slot, 1))
        return rooted

    # -- checks -------------------------------------------------------------

    def lockout_check(self, target_block: bytes, target_slot: int,
                      ghost: Ghost,
                      vote_blocks: dict[int, bytes]) -> bool:
        """May we vote for target without violating any lockout?
        vote_blocks maps our tower's vote slots to the blocks voted for
        (the tower stores slots; fork identity needs blocks)."""
        for v in self.votes:
            b = vote_blocks.get(v.slot)
            if b is not None and b in ghost.nodes \
                    and ghost.is_ancestor(b, target_block):
                continue                       # same fork: no lockout
            if target_slot > v.expiration:
                continue                       # expired by this vote
            return False
        return True

    def threshold_check(self, slot: int,
                        voter_towers: list[tuple[int, "Tower"]],
                        total_stake: int) -> bool:
        """2/3 of stake must support our vote at THRESHOLD_DEPTH.
        Each voter's tower is simulated voting for `slot` first, so
        long-stale votes expire and don't count
        (ref: fd_tower.c threshold_check)."""
        cnt = self.simulate(slot)
        if cnt < THRESHOLD_DEPTH:
            return True
        # depth 8 including the simulated vote at depth 0
        threshold_slot = self.votes[cnt - THRESHOLD_DEPTH].slot
        threshold_stake = 0
        for stake, tower in voter_towers:
            vcnt = tower.simulate(slot)
            if not vcnt:
                continue
            if tower.votes[vcnt - 1].slot >= threshold_slot:
                threshold_stake += stake
        return threshold_stake >= THRESHOLD_RATIO * total_stake

    def switch_check(self, target_block: bytes, last_vote_block: bytes,
                     ghost: Ghost) -> bool:
        """>= 38% of latest-vote stake must sit on GCA-descendant forks
        other than our own (ref: fd_tower.h switch-check diagram — the
        subtree of the GCA containing our last vote never counts, even
        branches of it that diverge above our vote)."""
        if last_vote_block not in ghost.nodes:
            return True                        # nothing voted: free switch
        gca = ghost.gca(last_vote_block, target_block)
        if gca == last_vote_block:
            return True                        # target on our fork: no switch
        own_child = ghost.path_child(gca, last_vote_block)
        switch_stake = sum(
            ghost.weight(cid)
            for cid in ghost.nodes[gca].children if cid != own_child)
        return switch_stake >= SWITCH_RATIO * ghost.total_stake
