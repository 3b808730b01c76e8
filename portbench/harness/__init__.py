"""The benchmark's harness: lookup by name (:mod:`.spec`), traffic (:mod:`.traffic`),
weights (:mod:`.weights`), the served window (:mod:`.serve`), the traced run
(:mod:`.trace`), the yardstick's counts (:mod:`.flops`, :mod:`.peaks`) and the
comparison that decides ``correct`` (:mod:`.check`)."""
