"""Share of the prefill positions over the window that were padding: one
minus the prompts' lengths over their buckets, in percent."""


def read(run):
    c = run.counters
    if not c["prefill_buckets"]:
        return None
    return 100.0 * (1.0 - sum(c["prefill_lengths"])
                    / sum(c["prefill_buckets"]))
