"""The benchmark's general machinery: the files of a cell found by name
(:mod:`.spec`), the inputs drawn from the seed (:mod:`.inputs`), the
program driven through its entry points (:mod:`.program`), one run of a
cell (:mod:`.cell`), the profiler's reduction (:mod:`.trace`), the
comparison that decides ``correct`` (:mod:`.check`) and the table of
peaks (:mod:`.peaks`)."""
