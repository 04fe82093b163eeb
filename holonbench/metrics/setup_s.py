"""setup_s: seconds from the process's start to the first timed pass (host
clock): loading the kernels (building them in a checkout's first run), the
log's draw on the device, the dataplane's build and its warm-up."""


def read(r) -> float:
    return r.setup_s
