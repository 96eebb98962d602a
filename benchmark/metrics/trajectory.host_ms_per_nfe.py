"""Host milliseconds per UNet evaluation inside ``Runner.restore``: from
entering it to its return, over every untraced restore of the window, per
NFE.  The step loop only enqueues, but its step tables are copied to the
card from pageable memory at the start of a trajectory, which waits for the
work already queued.  In the closed-loop cells the card is idle when a
restore starts, so this is the host's dispatch; in the offline cells the
restore of batch i + 1 waits for batch i, so this reads about the batch
period, not the host's own dispatch."""


def read(record):
    restores = record["window"]["restores"]
    if not restores:
        return None
    host_s = sum(b - a for a, b in restores)
    return 1e3 * host_s / (len(restores) * record["nfe"])
