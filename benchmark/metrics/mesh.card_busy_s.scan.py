"""mesh.card_busy_s.scan: the busiest card's device seconds per run: for
each card the sum of `device_ms` on its `mesh_launch` spans (two CUDA
events on that card's stream around each shard's program), the largest
of them. None on the CPU, or without a mesh pass's timed spans."""
from benchmark.waits import per_request, walk


def busiest_card_s(it):
    by_card = {}
    for span in walk(it.roots):
        if span.name == "mesh_launch" and "device_ms" in span.attrs:
            card = span.attrs.get("device")
            by_card[card] = by_card.get(card, 0.0) + span.attrs["device_ms"]
    return max(by_card.values()) / 1000.0 if by_card else None


def read(run):
    return per_request(run, busiest_card_s)
