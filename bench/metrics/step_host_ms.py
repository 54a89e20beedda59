"""Mean host time of a window step with the device waiting on the host:
the step (`dak.step`) less its prefill passes (`dak.prefill`) and less its
wait for the device's tokens (`dak.fetch`): admission, staging, the
launch, the finish (program span)."""
from bench import spans

LAYER, UNIT, SOURCE, MOVES, BETTER = "engine", "ms", "program_span", "tokens_per_s", "lower"


def read(r):
    steps = spans.window(r)
    if not steps:
        return None
    host = [s.seconds["dak.step"] - s.seconds.get("dak.prefill", 0.0)
            - s.seconds.get("dak.fetch", 0.0) for s in steps]
    return sum(host) / len(host) * 1e3
