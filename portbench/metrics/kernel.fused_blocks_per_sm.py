"""kernel.fused_blocks_per_sm: the MH kernel's resident blocks an SM at
its launches' shared memory, the mean over the traced calls' launches.
The program opens one range of no work, ``mh.blocks_per_sm.<k>``, inside
each launch of the CUDA kernel, ``k`` from CUDA's occupancy calculator
(host events read by name). None where no such range opens. Moves
``proposals_per_s``: fewer resident blocks take a launch of many chains
through the card in more waves."""

PREFIX = "mh.blocks_per_sm."


def read(ctx):
    calls = ctx.trace.calls
    ks = [int(n[len(PREFIX):]) for n, s, _ in ctx.trace.host
          if n.startswith(PREFIX) and n[len(PREFIX):].isdigit()
          and any(lo <= s <= hi for lo, hi in calls)]
    if not ks:
        return None
    return sum(ks) / len(ks)
