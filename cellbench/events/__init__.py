"""Events between ticks: faults and admin operations, one module each.

A mix names its module (``"events": {"module": <name>, ...}``), found as
``cellbench/events/<name>.py`` (:func:`cellbench.manifest.module`).  The
module has ``plan(params, G, seed)``, which gets the mix's other keys,
the configuration's group count and ``--seed`` and returns an object
with:

* ``every``: window ticks between rounds.  Round 0 is applied before the
  fill's first tick, round ``r >= 1`` before window tick
  ``(r - 1) * every``; the drain has none.
* ``rows(r)``: int64 numpy array, the sorted groups round ``r`` acts on,
  drawn from the seed alone.
* ``apply(state, inbox, at, groups, carry)``: round ``r`` on the
  program's state and mailbox, with ``at`` the rows of the state that
  hold ``groups`` (``rows(r)``), and ``carry`` what the previous round
  returned (None before round 0); returns ``(state, inbox, carry)``.
  Device ops only, out of place: the tick never writes its inputs in
  place.
* ``apply_reference``, optional: the same on the reference's state, whose
  rows are the replayed sample (``at`` are positions in it); ``apply``
  where absent.  It uses nothing of the program; a module that imports
  the program has to give it (:func:`cellbench.harness.events_apply_reference`).
* ``lost(carry)``: ``(at, hit)``, the rows the round named and whether it
  took away each one's service, for the failover reduction; None for an
  event that takes none away.

Rows are independent, so a round on the sampled rows of the reference
gives each of them what the whole batch gives it in the program.
"""
