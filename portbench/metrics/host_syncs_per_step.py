"""host_syncs_per_step (syncs/step): the program's host syncs
(``zpc_tpu_torch.utils.profile.HOST_SYNCS``, every site: the chain's
rebin flag, the CG's polls, the index tables copied from pageable host
memory) counted over the traced slice, per step of it."""


def read(t):
    syncs = [v for k, v in t.counters.items() if k.startswith("HOST_SYNCS.")]
    if t.steps == 0 or not syncs:
        return None
    return sum(syncs) / t.steps
