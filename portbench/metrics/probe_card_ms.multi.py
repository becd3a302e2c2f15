"""Card time a probe of a multi-card node takes from the node's workloads,
read as ``probe_card_ms`` reads it (the probe's cards' busy seconds,
summed over them, in a device trace of its own after the window, over
the probes that ended inside it). Held to a bound of its own: the NCCL
kernels start on each card as the host launches them and wait there for
the other cards, so their card time, and the probe's, swings with the
host's speed across the cards' launches."""

import catalog

read = catalog.reader("probe_card_ms")
