"""rebins_per_kstep (rebins/kstep): rebins the chain driver
(``adaptive_chain``) ran per 1,000 steps of the traced run's whole window
(every segment replays the same steps), counted by the benchmark's rebin
wrapper."""


def read(t):
    if t.window_steps == 0:
        return None
    return 1e3 * t.window_rebins / t.window_steps
