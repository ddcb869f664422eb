"""The least time a call of a cell could take on the card, from its
shapes alone: the larger of reading the corpus once at the traffic's
narrowest admissible width and the batch's multiply-adds at that type's
dense peak (``peaks.json``). It prices the work, not an implementation,
so it holds whatever kernel serves the call."""


def least_seconds(config: dict, traffic: dict, peaks: dict) -> float:
    n, d, b = int(config["rows"]), int(config["dim"]), int(traffic["batch"])
    roof = traffic["roofline"]
    read_s = n * d * float(roof["bytes_per_element"]) / peaks["hbm_bytes_per_s"]
    ops_s = 2.0 * b * n * d / peaks[roof["peak"]]
    return max(read_s, ops_s)
