"""rank.device_idle_share: % of the profiled sub-window (whole-split passes)
in which no operation ran on the card.  Moves rank_queries_per_s."""


def read(r):
    if r.info.get("kind") != "rank":
        return None
    return r.device_idle_share()
