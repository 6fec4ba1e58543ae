"""The share of the held experts' computed rows that carry a routed
pair, over the decode ticks outside the profiled slice: 100 x the
ticks' summed ``expert_pairs`` (the live rows' token-expert pairs routed
to the experts the card holds, over the MoE layers) over their summed
``expert_rows`` (the token-expert rows those experts computed), in %; a
program counter.  A tick that runs every held expert over every row
slot reads low; one that computes the routed pairs alone reads 100.
Silent where the program records no ``expert_rows``."""

from portbench.readers import calls


def read(w):
    ticks = [c["attrs"] for c in calls(w, "decode_tick")
             if "expert_rows" in c["attrs"]]
    rows = sum(a["expert_rows"] for a in ticks)
    if not rows:
        return None
    return 100.0 * sum(a["expert_pairs"] for a in ticks) / rows
