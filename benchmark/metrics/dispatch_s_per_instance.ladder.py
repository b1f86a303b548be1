"""Host seconds per instance in the balancing ladder not spent blocked
waiting for the device: the program's stage "ladder" less the counters
``#wait_s`` of its keys (its reads of the device and the synchronizes
that end its keys), over a traced run's window."""


def read(run):
    st = run.stage_times
    if not st or not run.completed or "ladder" not in st:
        return None
    waits = [v for k, v in st.items()
             if k.endswith("#wait_s")
             and k.split("#")[0].split("/")[0] == "ladder"]
    if not waits:
        return None
    return (st["ladder"] - sum(waits)) / run.completed
