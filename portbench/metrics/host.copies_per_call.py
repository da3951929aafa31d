"""host.copies_per_call: the copies a call makes between host and cards or
among cards, counted on the cards' timeline: the ``Memcpy`` device events
(not ``Memset``) that start inside the traced calls, divided by the number
of traced calls. None where no call was traced. Moves ``proposals_per_s``:
each copy costs a call its launch, and a copy from pageable memory or back
to the host a wait on the card."""


def read(ctx):
    calls = ctx.trace.calls
    if not calls:
        return None
    copies = sum(1 for n, _, s, _ in ctx.trace.device
                 if n.startswith("Memcpy") and any(lo <= s <= hi for lo, hi in calls))
    return copies / len(calls)
