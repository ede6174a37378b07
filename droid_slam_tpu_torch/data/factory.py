"""Dataset factory: the training datasets named on the command line,
concatenated (a copy of ``droid_slam_tpu/data/factory.py``)."""

from __future__ import annotations


def dataset_factory(dataset_list, **kwargs):
    """Concatenate the requested training datasets."""
    from .tartan import TartanAir

    factory = {"tartan": TartanAir}
    db_list = []
    for key in dataset_list:
        if key not in factory:
            raise ValueError(f"unknown dataset {key}")
        db_list.append(factory[key](**kwargs))

    if len(db_list) == 1:
        return db_list[0]
    return ConcatDataset(db_list)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.lengths = [len(d) for d in datasets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, index):
        for d, n in zip(self.datasets, self.lengths):
            if index < n:
                return d[index]
            index -= n
        raise IndexError
