"""Host<->device transfer accounting for the device-resident decode path.

Port of libhm_tpu/utils/xfer.py.  The host->device syntax upload and the
device->host picture download are the communication layer of the decoder,
so their byte counts are a first-class metric.

Counters are process-global plain ints; reset() before a run, then read
H2D/D2H (bytes), BY_TAG (bytes by tag) and UPLOADS (copies by tag).
Copies between two devices (a reference plane that a multi-device decode
reads on another device than the one that made it) count under tag
"peer" in BY_TAG and UPLOADS, and not in H2D.  Each copy is also a span
(utils/obs.py), "upload.<tag>" or "upload.peer", whose n is its bytes.
"""
import torch

from . import obs

H2D = 0
D2H = 0
BY_TAG = {}
UPLOADS = {}


def reset():
    global H2D, D2H
    H2D = 0
    D2H = 0
    BY_TAG.clear()
    UPLOADS.clear()


def up(a, tag, device):
    """torch.from_numpy(a).to(device) with upload byte accounting."""
    global H2D
    H2D += a.nbytes
    BY_TAG[tag] = BY_TAG.get(tag, 0) + a.nbytes
    UPLOADS[tag] = UPLOADS.get(tag, 0) + 1
    with obs.span("upload." + tag, a.nbytes):
        return torch.from_numpy(a).to(device)


def count_d2h(n):
    global D2H
    D2H += n


def peer(t, device):
    """t.to(device), counting a copy and its bytes under tag "peer" when
    the tensor lies on another device."""
    device = torch.device(device)
    if t.device == device:
        return t
    BY_TAG["peer"] = BY_TAG.get("peer", 0) + t.nbytes
    UPLOADS["peer"] = UPLOADS.get("peer", 0) + 1
    with obs.span("upload.peer", t.nbytes):
        return t.to(device)
