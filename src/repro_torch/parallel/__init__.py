"""The port's multi-device runtime: logical-axis sharding on a ``DeviceMesh``
(``sharding``), explicit data parallelism (``dp_explicit``) with int8
error-feedback gradient compression (``compression``), the GPipe pipeline
(``pipeline``), and N gloo ranks on one host for tests (``spawn``)."""
