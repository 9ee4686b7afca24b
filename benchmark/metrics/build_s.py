"""The synchronised wall time of the store's build: the ingest from the
benchmark's f32 tensor into the stored dtype, the columns and the zonemaps."""


def read(rec):
    return rec.build_s
