"""compress_host_s: seconds the process spent in the program's
``alp.compress`` spans (``compress_device``, in set-up) less those of the
``alp.fetch.*`` spans inside them (waits on the device), from
``alp_tpu_torch.tracing.totals()``, host clock.  None where the program has
no such span."""

from harness import spans


def read(run):
    got = (spans.program_totals() or {}).get("alp.compress")
    return None if got is None else got["seconds"] - got["fetch_seconds"]
