"""Bytes of the compressed bitmap index per fact row: ``/stats``
``size_words`` x 4 over the rows."""


def read(rec):
    return 4.0 * rec["size_words"] / rec["n_rows"]
