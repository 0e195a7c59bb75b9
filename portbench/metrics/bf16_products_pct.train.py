"""The share of the training step's library products that ran as bf16
tensor-core products: the port's "product.bf16" spans over all its
"product.bf16" and "product.f32" spans (models/products.product, forward
and backward) in the traced steps. A count: the same on every run of a
model. Silent where the program opens neither span."""

from portbench import spans


def read(rec):
    if rec is None:
        return None
    bf16 = spans.count(rec, "product.bf16")
    total = bf16 + spans.count(rec, "product.f32")
    return 100.0 * bf16 / total if total else None
