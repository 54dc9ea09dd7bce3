"""Print the VOC2012 and SBD sources and md5-verify the archives already on
disk, the port of ``examples/voc/download_datasets.py`` (the reference's
examples/voc/download_datasets.py). Nothing is fetched.

    python -m mask_rcnn_tpu_torch.examples.voc.download_datasets
"""


def main(argv=None):
    import argparse

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    from mask_rcnn_tpu_torch.data import (
        SBDInstanceSegmentationDataset,
        VOC2012InstanceSegmentationDataset,
    )

    VOC2012InstanceSegmentationDataset.download()
    SBDInstanceSegmentationDataset.download()
    print("Place under ~/data/datasets/VOC/")


if __name__ == "__main__":
    main()
