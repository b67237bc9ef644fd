"""readbacks (copies/analysis), layer fused program: device-to-host copies
in the traced window, each a host wait that leaves the card idle (the
bandwidth bisections read a flag back every iteration)."""


def read(window):
    if not window.analyses:
        return None
    copies = sum(1 for name, _, _ in window.device_ops if name.startswith("Memcpy DtoH"))
    return copies / len(window.analyses)
