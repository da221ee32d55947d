"""petastorm_tpu_torch.transform against the JAX package's: the schema a
TransformSpec gives, for edits, removals, selections and a selected field
that does not exist, must be equal, and the error must be the same."""
import numpy as np
import pytest

from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.transform import TransformSpec as JaxSpec, transform_schema as jax_transform
from petastorm_tpu.unischema import Unischema as JaxSchema, UnischemaField as JaxField
from petastorm_tpu_torch import TransformSpec
from petastorm_tpu_torch.codecs import NdarrayCodec
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def _schemas():
    fields = [("id", np.int64, (), False), ("image", np.uint8, (32, 32, 3), False),
              ("label", np.int32, (), True), ("name", np.str_, (), True)]
    port = Unischema("S", [UnischemaField(n, d, s, NdarrayCodec() if s else None, nl)
                           for n, d, s, nl in fields])
    jax = JaxSchema("S", [JaxField(n, d, s, JaxNdarrayCodec() if s else None, nl)
                          for n, d, s, nl in fields])
    return port, jax


def _summary(schema):
    return [(f.name, np.dtype(f.numpy_dtype).str, tuple(f.shape), f.nullable,
             type(f.codec).__name__) for f in schema.fields.values()], schema.name


SPECS = {
    "edit shape": dict(edit_fields=[("image", np.uint8, (24, 24, 3), False)]),
    "edit dtype and add": dict(edit_fields=[("label", np.float32, (), False),
                                            ("extra", np.float64, (4,), True)]),
    "remove": dict(removed_fields=["name", "label"]),
    "remove absent": dict(removed_fields=["nope"]),
    "select": dict(selected_fields=["label", "id"]),
    "edit remove select": dict(edit_fields=[("mask", np.bool_, (32, 32), False)],
                               removed_fields=["image"], selected_fields=["mask", "id"]),
    "nothing": dict(),
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_transform_schema_equals_the_jax_schema(case):
    port_schema, jax_schema = _schemas()
    got = transform_schema(port_schema, TransformSpec(**SPECS[case]))
    want = jax_transform(jax_schema, JaxSpec(**SPECS[case]))
    assert _summary(got) == _summary(want)


def test_edit_fields_take_unischema_fields_and_five_tuples():
    port_schema, jax_schema = _schemas()
    got = transform_schema(port_schema, TransformSpec(edit_fields=[
        UnischemaField("a", np.int16, (2,), None, False),
        ("b", np.float32, (3,), NdarrayCodec(), True)]))
    want = jax_transform(jax_schema, JaxSpec(edit_fields=[
        JaxField("a", np.int16, (2,), None, False),
        ("b", np.float32, (3,), JaxNdarrayCodec(), True)]))
    assert _summary(got) == _summary(want)


@pytest.mark.parametrize("spec", [dict(selected_fields=["id", "missing"]),
                                  dict(removed_fields=["id"], selected_fields=["id"])],
                         ids=["missing", "removed then selected"])
def test_missing_selected_field_raises_as_the_jax_package(spec):
    port_schema, jax_schema = _schemas()
    with pytest.raises(ValueError) as want:
        jax_transform(jax_schema, JaxSpec(**spec))
    with pytest.raises(ValueError) as got:
        transform_schema(port_schema, TransformSpec(**spec))
    assert str(got.value) == str(want.value)


def test_spec_keeps_its_arguments():
    spec = TransformSpec(len, batched=True, removed_fields=("x",), selected_fields=("y",))
    assert spec.func is len and spec.batched and spec.removed_fields == ["x"]
    assert spec.selected_fields == ["y"] and spec.edit_fields == []
    assert TransformSpec().selected_fields is None
