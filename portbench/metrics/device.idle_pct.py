"""device.idle_pct: the share of the traced window in which the card runs
no kernel or copy, in %; on several cards the mean over the cards. Moves
``proposals_per_s``."""


def read(ctx):
    window = ctx.trace.window_us
    busy = ctx.trace.busy_us_per_card()
    if window <= 0 or not any(busy):
        return None
    return 100.0 * (1.0 - sum(busy) / len(busy) / window)
