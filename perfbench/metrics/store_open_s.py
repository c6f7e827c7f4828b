"""Host seconds of ``QueryService.from_dir(store, mmap=True,
device="cuda")``: opening the saved store and the service over it."""


def read(rec):
    return rec["store_open_s"]
