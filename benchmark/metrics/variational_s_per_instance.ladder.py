"""Seconds per instance of the variational passes (``bmps._alternate``)
in the program's stage "ladder": the counters ``#variational_s`` of the
stage's keys (host seconds from each pass loop's first stop read to its
last, device-inclusive), summed over a traced run's window."""

STAGE = "ladder"


def read(run):
    st = run.stage_times
    if not st or not run.completed:
        return None
    found = [v for k, v in st.items()
             if k.endswith("#variational_s")
             and k.split("#")[0].split("/")[0] == STAGE]
    return sum(found) / run.completed if found else None
