"""crf.launches: device operations (kernels, memsets, copies) launched
inside the range around the entry's ``mean_field``, per call.  Layer:
the CRF loop."""


def read(view, run):
    calls = view.range_count('crf.mean_field')
    if not calls:
        return None
    ops = view.in_range('crf.mean_field')
    if not ops:
        return None
    return len(ops) / calls
